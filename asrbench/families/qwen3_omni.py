"""Qwen3-Omni-30B-A3B's thinker: the windowed AuT tower and 48 Qwen3-MoE
decoder layers of 128 experts (top 8, renormalised), speech in, text out.

The configuration file holds the published `text_config` at its top level
and the `audio_config` group (`asrbench/configs/qwen3-omni-30b-a3b-
thinker.json`). The whole model does not fit twice on one card (its bf16
tree alone is ~62 GB beside the program's ~32 GB), so the weights are made
a part at a time, each a pure function of (configuration, seed, part,
layer): the tower, the top (embedding, final norm, untied head) and each
decoder layer. `load` hands the program its decoder a layer at a time,
rounded to the program's int8 leaves before the next layer is made (the
mix runs the door with `quantize` "int8pc"); `reference` runs every judged
request through one float32 layer at a time (`reference/qwen3_omni.py`,
~2.5 GB a layer at the published widths).

The work counts (`request_ops`, `step_work`, and the expert kernels' bytes
and operations for the `moe_*_roofline` readers) count the active path: a
token's attention, router and k experts, the head.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from asrbench import weights, work
from asrbench.doors import byte_vocab
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel
from asrbench.reference import prompt as rprompt
from asrbench.reference import qwen3_omni as romni

PARTS = ("encoder", "top", "layer")
ATTENTION = ("wq", "wk", "wv", "wo")


def view(cfg: dict) -> dict:
    """The shapes under the keys `work.py`, `weights.py` and the reference's
    tower and prompt read (the `qwen3_asr` family's layout)."""
    return {"audio": romni.audio_view(cfg),
            "text": {"decoder_layers": cfg["num_hidden_layers"],
                     "hidden_size": cfg["hidden_size"],
                     "attention_heads": cfg["num_attention_heads"],
                     "num_key_value_heads": cfg["num_key_value_heads"],
                     "head_dim": cfg["head_dim"],
                     "intermediate_size": cfg["moe_intermediate_size"],
                     "rms_norm_eps": cfg["rms_norm_eps"], "rope_theta": cfg["rope_theta"]},
            "vocab_size": cfg["vocab_size"], "tokens": cfg["tokens"], "init": cfg["init"]}


def port_config(cfg: dict):
    """The program's ASRModelConfig: the windowed tower, the MoE decoder,
    EOS switched off. Every layer is sparse (decoder_sparse_step 1,
    mlp_only_layers []); the program runs no other layout."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig, AudioEncoderConfig, MoeDecoderConfig

    if cfg["decoder_sparse_step"] != 1 or cfg["mlp_only_layers"]:
        raise ValueError("the program runs an MoE block in every decoder layer")
    if cfg.get("shared_expert_intermediate_size", 0):
        raise ValueError("the program has no shared expert")
    if not cfg["norm_topk_prob"]:
        raise ValueError("the program renormalises the top k's weights (norm_topk_prob)")
    a, v, tok = cfg["audio_config"], view(cfg)["audio"], cfg["tokens"]
    enc = AudioEncoderConfig(
        n_layers=a["encoder_layers"], d_model=a["d_model"], n_heads=a["encoder_attention_heads"],
        ffn_dim=a["encoder_ffn_dim"], conv_channels=a["downsample_hidden_size"],
        n_mel_bins=a["num_mel_bins"], output_dim=a["output_dim"],
        layer_norm_eps=v["layer_norm_eps"], n_window=a["n_window"],
        n_window_infer=a["n_window_infer"])
    dec = MoeDecoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        intermediate_size=cfg["intermediate_size"], rms_norm_eps=cfg["rms_norm_eps"],
        rope_theta=float(cfg["rope_theta"]), pad_token_id=tok["pad"], eos_token_id=-1,
        audio_start_token_id=tok["audio_start"], audio_end_token_id=tok["audio_end"],
        audio_pad_token_id=tok["audio_pad"], im_start_token_id=tok["im_start"],
        im_end_token_id=tok["im_end"], system_token_id=tok["system"],
        user_token_id=tok["user"], assistant_token_id=tok["assistant"],
        newline_token_id=tok["newline"], n_experts=cfg["num_experts"],
        n_experts_per_tok=cfg["num_experts_per_tok"],
        moe_intermediate_size=cfg["moe_intermediate_size"])
    return ASRModelConfig(encoder=enc, decoder=dec)


# -- weights ---------------------------------------------------------------------

def _leaves(cfg: dict, part: str) -> list:
    """[(path, shape, group)] of a part: groups "decoder" (N(0, std^2),
    bf16), "embed" (the same), "ones", and the tower's groups as
    `weights.leaves` gives them."""
    h, E, F = cfg["hidden_size"], cfg["num_experts"], cfg["moe_intermediate_size"]
    D, V = cfg["head_dim"], cfg["vocab_size"]
    qd, kvd = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D
    if part == "layer":
        mats = [(("wq",), (h, qd)), (("wk",), (h, kvd)), (("wv",), (h, kvd)),
                (("wo",), (qd, h)), (("router",), (h, E)),
                (("experts_gate",), (E, h, F)), (("experts_up",), (E, h, F)),
                (("experts_down",), (E, F, h))]
        if "expert_spread" in cfg["init"]:   # a base the layer's experts share
            mats += [((f"{k}_base",), s[1:]) for (k,), s in mats[-3:]]
        ones = [(("attn_norm",), (h,)), (("q_norm",), (D,)), (("k_norm",), (D,)),
                (("ffn_norm",), (h,))]
        return [(p, s, "decoder") for p, s in mats] + [(p, s, "ones") for p, s in ones]
    if part == "top":
        return [(("token_embd",), (V, h), "embed"), (("lm_head",), (h, V), "embed"),
                (("output_norm",), (h,), "ones")]
    out = []
    for group, items in weights.leaves(view(cfg)).items():
        out += [(path[1:], shape, group) for path, shape in items if path[0] == "encoder"]
    return out


NORMAL = {"encoder": torch.bfloat16, "decoder": torch.bfloat16, "embed": torch.bfloat16,
          "conv": torch.float32}
FILL = {"ones": (torch.ones, torch.bfloat16), "zeros": (torch.zeros, torch.bfloat16),
        "conv_bias": (torch.zeros, torch.float32)}


def make(cfg: dict, seed: int, part: str, device, layer: int = 0, dtype=None) -> dict:
    """The weights of `part` (and `layer`) from a generator seeded by (seed,
    part, layer) alone, each normal group in one draw; in `dtype` (float32
    for the reference) or as served. A leaf's std is `init[<leaf>_std]`, else
    `init["std"]`; with `init["expert_spread"]` r, expert e of a layer's
    gate, up and down matrices is (base + r * own_e) / sqrt(1 + r^2), base
    and own_e drawn alike (the configuration's `assumed` says why)."""
    state = np.random.SeedSequence([seed % 2 ** 63, PARTS.index(part), layer])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]) % 2 ** 63)
    items = _leaves(cfg, part)
    init = cfg["init"]
    tree: dict = {}

    def put(path, value):
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = value if dtype is None else value.to(dtype)

    for group, kind in NORMAL.items():
        mine = [(p, s) for p, s, g in items if g == group]
        sizes = [int(np.prod(s)) for _, s in mine]
        if not mine:
            continue
        buf = torch.randn(sum(sizes), generator=gen, dtype=kind, device=device)
        off = 0
        for (path, shape), n in zip(mine, sizes):
            std = init["conv1_std"] if path[-1] == "conv1_w" else init.get(
                f"{path[-1]}_std", init["std"])
            put(path, buf[off:off + n].view(shape).mul_(std))
            off += n
        del buf
    for path, shape, group in items:
        if group in FILL:
            fn, kind = FILL[group]
            put(path, fn(shape, dtype=kind, device=device))
    r = init.get("expert_spread")
    if part == "layer" and r is not None:
        for k in romni.EXPERT_MATRICES:
            base = tree.pop(f"{k}_base")
            tree[k] = (base[None] + r * tree[k]) / float(np.sqrt(1 + r * r))
    return tree


def load(program, cfg: dict, seed: int, device) -> None:
    """The tower and the top whole (the head rounded to the program's int8
    `lm_head_pc`); the decoder a layer at a time, each rounded to the
    program's leaves (the attention's int8pc, the experts' `ops/moe.py`
    leaves, the router bf16) and stacked before the next layer is made.
    The program must run int8pc (the mix's door argument `quantize`)."""
    from qwen3_asr_tpu_torch.ops.moe import expert_leaves
    from qwen3_asr_tpu_torch.ops.q8_matmul import quantize_pc_weights

    if program.quantize != "int8pc":
        raise ValueError(f"{__name__} hands int8pc leaves, the program runs {program.quantize!r}")
    L = cfg["num_hidden_layers"]
    layers: dict = {}

    def into(slot: dict, key: str, l: int, v: torch.Tensor) -> None:
        if key not in slot:
            slot[key] = torch.empty((L,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        slot[key][l] = v

    for l in range(L):
        lw = make(cfg, seed, "layer", device, l)
        for k in ATTENTION:
            q, s = quantize_pc_weights(lw.pop(k))
            into(layers.setdefault(k, {}), "i8pc:q", l, q)
            into(layers[k], "i8pc:s", l, s)
        gu, dn = expert_leaves(lw.pop("experts_gate"), lw.pop("experts_up"),
                               lw.pop("experts_down"))
        for key, leaf in (("experts_gu", gu), ("experts_down", dn)):
            for n, v in leaf.items():
                into(layers.setdefault(key, {}), n, l, v)
        for k, v in lw.items():
            into(layers, k, l, v)
        del lw, gu, dn
    top = make(cfg, seed, "top", device)
    q, s = quantize_pc_weights(top.pop("lm_head"))
    dec = dict(top, layers=layers, lm_head_pc={"i8pc:q": q, "i8pc:s": s})
    tree = {"encoder": make(cfg, seed, "encoder", device), "decoder": dec}
    program._finish_load(port_config(cfg), tree, byte_vocab(cfg["vocab_size"]), [])


# -- the plain reference ---------------------------------------------------------

def prompt(cfg: dict, kind: str, req) -> tuple[list[int], int]:
    if kind != "asr":
        raise ValueError(f"{__name__} transcribes; it has no {kind!r} requests")
    return rprompt.asr_prompt(view(cfg), rprompt.audio_rows(rmel.n_mel_frames(req.n_samples)))


def reference(cfg: dict, seed: int, device, jobs: list, control: bool = False) -> list:
    """[(logits, control's logits or None)] a job: the tower a job at a
    time, then every job's rows through one float32 decoder layer at a time.
    The control's rows go through the same layer once its expert matrices
    are rounded to int4 in place (`romni.int4_experts`), so one layer's
    float32 weights are alive at once with the control too."""
    v = view(cfg)
    enc = rmodel.f32(make(cfg, seed, "encoder", device))
    audio = [rmodel.encode(enc, v, rmel.log_mel(j.pcm, device)) for j in jobs]
    del enc
    top = rmodel.f32(make(cfg, seed, "top", device))
    hs = [rmodel.embed(top, j.tokens, a, j.audio_offset) for j, a in zip(jobs, audio)]
    lows = list(hs) if control else None
    for l in range(cfg["num_hidden_layers"]):
        lw = make(cfg, seed, "layer", device, l, torch.float32)
        hs = [romni.decoder_layer(lw, cfg, h) for h in hs]
        if control:
            romni.int4_experts(lw)
            lows = [romni.decoder_layer(lw, cfg, h) for h in lows]
        del lw
    return [(romni.lm_logits(top, cfg, h[j.rows]),
             romni.lm_logits(top, cfg, lows[i][j.rows]) if control else None)
            for i, (h, j) in enumerate(zip(hs, jobs))]


# -- work ------------------------------------------------------------------------

def expert_bytes(cfg: dict) -> int:
    """One expert's int8 codes and f32 output-channel scales, one layer."""
    h, F = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 3 * h * F + 4 * (2 * F + h)


def router_bytes(cfg: dict) -> int:
    """One layer's router, bf16."""
    return 2 * cfg["hidden_size"] * cfg["num_experts"]


def active_weights(cfg: dict) -> int:
    """The weights one row multiplies, all layers: the attention's, the
    router's and its k experts'."""
    h, D, F = cfg["hidden_size"], cfg["head_dim"], cfg["moe_intermediate_size"]
    qd, kvd = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D
    per = (h * (qd + 2 * kvd) + qd * h + h * cfg["num_experts"]
           + cfg["num_experts_per_tok"] * 3 * h * F)
    return cfg["num_hidden_layers"] * per


def request_ops(cfg: dict, kind: str, req) -> float:
    """A transcription's operations (2 x multiply-adds): the conv stem and
    the windowed tower, the prefill's active path over the prompt and its
    causal attention, the head on its last row, and max_tokens - 1 decode
    steps, each with the head."""
    v = view(cfg)
    s = work.asr_request(v, req.n_samples, req.max_tokens)
    P = s["n_prompt"]
    macs = (work.encoder_macs(v, s["n_frames"]) + P * active_weights(cfg)
            + work.attention_macs(v, 1) * P * (P + 1) // 2 + work.head_weights(v))
    for p in s["positions"]:
        macs += active_weights(cfg) + work.head_weights(v) + work.attention_macs(v, p + 1)
    return 2.0 * macs


def decode_positions(cfg: dict, req) -> list[int]:
    return work.asr_request(view(cfg), req.n_samples, req.max_tokens)["positions"]


def step_work(cfg: dict, positions: list[int], kv: str) -> tuple[float, float]:
    """(bytes, operations) of one decode step of rows at `positions`: the
    attention's int8 weights and scales, the routers, k experts a row a
    layer (each row's own: rows seldom share), the head once; each row's
    live cache and fresh row."""
    v = view(cfg)
    h, D, L = cfg["hidden_size"], cfg["head_dim"], cfg["num_hidden_layers"]
    qd, kvd = cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D
    K, B = cfg["num_experts_per_tok"], len(positions)
    attn = L * (h * (qd + 2 * kvd) + qd * h + 4 * (qd + 2 * kvd + h))
    head = work.head_weights(v) + 4 * cfg["vocab_size"]
    experts = L * B * K * expert_bytes(cfg)
    row = work.cache_row_bytes(v, kv)
    nbytes = (attn + L * router_bytes(cfg) + experts + head
              + sum((p + 1) * row for p in positions))
    ops = 2.0 * (active_weights(cfg) + work.head_weights(v)) * B + sum(
        2.0 * work.attention_macs(v, p + 1) for p in positions)
    return nbytes, ops


def moe_decode_bytes(cfg: dict) -> int:
    """The expert kernels' bytes of one decode step at B = 1: each layer's k
    routed experts (int8 codes and scales) and its router."""
    return cfg["num_hidden_layers"] * (cfg["num_experts_per_tok"] * expert_bytes(cfg)
                                       + router_bytes(cfg))


def moe_prefill_least(cfg: dict, touched: int, pairs: int) -> float:
    """The grouped products' least seconds for a prefill whose layers touched
    `touched` experts in all and routed `pairs` (row, expert) pairs: the
    larger of the touched experts' bytes at HBM_BPS and the pairs' int8
    operations (gate, up and down) at INT8_OPS."""
    ops = 2.0 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] * pairs
    return work.bound(touched * expert_bytes(cfg), ops, work.INT8_OPS)


def tiny(cfg: dict) -> dict:
    """The configuration at test widths: 2 + 2 layers, hidden 64, 8 query
    heads of 16 on 2 KV heads, 8 experts of 32, top 2, a 512-entry
    vocabulary (the special ids at its top), M-RoPE sections [4, 2, 2]. The
    weights are N(0, 0.3^2), as `qwen3_asr.tiny` makes them."""
    c = copy.deepcopy(cfg)
    c["audio_config"].update(encoder_layers=2, num_hidden_layers=2, d_model=32,
                             encoder_attention_heads=4, encoder_ffn_dim=64,
                             downsample_hidden_size=8, output_dim=64)
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=8,
             num_key_value_heads=2, head_dim=16, intermediate_size=32,
             moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2, vocab_size=512)
    c["rope_scaling"] = dict(c["rope_scaling"], mrope_section=[4, 2, 2])
    V = 512
    c["tokens"] = {k: V - 1 - i for i, k in enumerate(sorted(c["tokens"]))}
    c["tokens"]["im_end"] = c["tokens"]["eos"]
    c["init"] = {"std": 0.3, "conv1_std": 0.1}
    return c
