"""The port's MoE path (Qwen3-Omni-30B-A3B's thinker) on the CPU, where
its kernels take their plain twins (`ops/moe.py`): the tiny thinker held
against the plain float32 reference (`tests/plain_qwen3_omni.py`), the
grouped expert products held against a row-by-row computation, M-RoPE
with equal position rows against the port's RoPE, the benchmark's
configuration file against the published config, the two reference copies
against each other, and every path without an MoE block raising with its
name."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import plain_qwen3_omni as plain
import pytest
import torch

from qwen3_asr_tpu_torch.audio.mel import mel_device
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.decoder import (
    embed_with_audio,
    lm_logits,
    lm_logits_block,
    rope_neox,
)
from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
from qwen3_asr_tpu_torch.models.encoder import encode
from qwen3_asr_tpu_torch.models.generate import mega_caches, prefill_hidden
from qwen3_asr_tpu_torch.ops import moe as tmoe
from qwen3_asr_tpu_torch.ops.megakernel import _attention_ref, _bf, _quant_row
from qwen3_asr_tpu_torch.ops.prefill_fused import codes_buffer, norm_quant_rows
from qwen3_asr_tpu_torch.ops.q8_matmul import quantize_rows, rms_norm_f32
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "asrbench" / "configs" / "qwen3-omni-30b-a3b-thinker.json")
                    .read_text())

# The published thinker_config.text_config of Qwen/Qwen3-Omni-30B-A3B-
# Instruct (config.json) that the configuration file must hold, key for key.
PUBLISHED = {
    "attention_bias": False, "attention_dropout": 0.0, "decoder_sparse_step": 1,
    "head_dim": 128, "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 768, "max_position_embeddings": 65536, "mlp_only_layers": [],
    "moe_intermediate_size": 768, "norm_topk_prob": True, "num_attention_heads": 32,
    "num_experts": 128, "num_experts_per_tok": 8, "num_hidden_layers": 48,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_scaling": {"interleaved": True, "mrope_interleaved": True,
                     "mrope_section": [24, 20, 20], "rope_type": "default",
                     "type": "default"},
    "rope_theta": 1000000, "router_aux_loss_coef": 0.001, "sliding_window": None,
    "use_sliding_window": False, "vocab_size": 152064,
}
PUBLISHED_AUDIO = {
    "d_model": 1280, "downsample_hidden_size": 480, "encoder_attention_heads": 20,
    "encoder_ffn_dim": 5120, "encoder_layers": 32, "n_window": 50, "n_window_infer": 800,
    "num_mel_bins": 128, "output_dim": 2048,
}

# The tiny port against the float32 reference, a row's logits at a time
# (every prompt row and 8 decode steps): int8 weights (per output channel)
# and int8 activation codes (per row) in every product, a bf16 tower and
# residual stream, over 2 + 2 layers, put a row's logits 2-5% off in
# relative L2 (the median over a request's 62 rows, seeds 1-8 on both
# caches: 0.026-0.047). The rounding also moves a row's top-k across a near
# tie of the router now and then, and the row then takes another expert:
# 0-7 of the 62 rows past REL_L2 (up to 0.92), the reference's mean gap at
# the port's argmax 0-0.10 (seeds 1-8). So: the median under MEDIAN_REL, at
# most MAX_FLIPPED of the rows past REL_L2, the mean gap under MEAN_GAP. A
# wrong routing reads a median of tens of percent
# (`test_a_wrong_routing_is_far`).
MEDIAN_REL = 0.06
REL_L2 = 0.12
MAX_FLIPPED = 0.2
MEAN_GAP = 0.3


def family():
    from asrbench import registry

    return registry.family(CONFIG)


def tiny_cfg() -> dict:
    return family().tiny(CONFIG)


def weights(cfg: dict, seed: int, dtype=None) -> dict:
    """The family's seeded weights of every part, the layers stacked: bf16
    as served (dtype None) or float32 for the reference."""
    fam = family()
    layers = [fam.make(cfg, seed, "layer", "cpu", l, dtype)
              for l in range(cfg["num_hidden_layers"])]
    return {"encoder": fam.make(cfg, seed, "encoder", "cpu", dtype=dtype),
            "decoder": dict(fam.make(cfg, seed, "top", "cpu", dtype=dtype),
                            layers={k: torch.stack([lw[k] for lw in layers])
                                    for k in layers[0]})}


def port(cfg: dict, tree: dict, kv_cache: str = "bf16") -> Qwen3ASR:
    from asrbench.doors import byte_vocab

    asr = Qwen3ASR(quantize="int8pc", kv_cache=kv_cache, device="cpu")
    asr._finish_load(family().port_config(cfg), tree, byte_vocab(cfg["vocab_size"]), [])
    return asr


def pcm(seed: int, seconds: float = 3.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.3 * np.sin(3 * t)))
    return ((x + 0.05 * rng.standard_normal(t.size)) * 20000).astype(np.int16)


def port_and_reference_logits(cfg, asr, ref_tree, samples, n_steps: int = 8):
    """The port's logits of every prompt row of its prefill and of n_steps
    greedy decode steps through its cache (the MoE step's twin), and the
    reference's logits of the whole sequence at the same rows, on the
    port's log-mel."""
    buf, n_frames = _pad_pcm(samples)
    mel = mel_device(torch.from_numpy(buf), asr.filters_t, n_frames).T
    pc = asr.cfg
    feats = encode(asr.params["encoder"], pc.encoder, mel, n_frames)
    dcfg, dec = pc.decoder, asr.params["decoder"]
    prompt = build_asr_prompt(feats.shape[0], dcfg)
    off = audio_start_pos(prompt, dcfg)
    P = len(prompt)
    h0 = embed_with_audio(dec, torch.tensor(prompt, dtype=torch.int32), feats,
                          feats.shape[0], off)
    cache = tdec.init_kv_cache(dcfg, 256, "cpu", asr.cache_dtype)
    got = [lm_logits_block(dec, dcfg, tdec.decoder_forward(dec, dcfg, h0, cache, P))]
    kvs = mega_caches(dcfg, cache, asr.cache_dtype)
    seq = list(prompt)
    tok = torch.argmax(got[0][-1]).to(torch.int32).reshape(1)
    for _ in range(n_steps):
        seq.append(int(tok))
        tok, _, logits = tmoe.moe_decode_step_ref(dec["moe"], dcfg, tok, len(seq) - 1, *kvs,
                                                  return_logits=True)
        got.append(logits[None])
    return torch.cat(got), plain.forward(ref_tree, cfg, mel.float(), seq, off)


def agreement(got, want) -> tuple[float, float, float]:
    """(median relative L2 error of a row's logits, the share of rows past
    REL_L2, the reference's mean gap at the port's argmax)."""
    rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
    gap = want.max(-1).values - want.gather(1, got.argmax(-1)[:, None])[:, 0]
    return float(rel.median()), float((rel > REL_L2).float().mean()), float(gap.mean())


# -- the configuration file --------------------------------------------------------

@pytest.mark.parametrize("key", sorted(PUBLISHED))
def test_config_holds_the_published_text_config(key):
    """Every published key at the top level, its value and type as published
    (None only where the published value is null)."""
    assert key in CONFIG
    want, got = PUBLISHED[key], CONFIG[key]
    assert got == want and type(got) is type(want), (key, got, want)
    assert got is not None or want is None


@pytest.mark.parametrize("key", sorted(PUBLISHED_AUDIO))
def test_config_holds_the_published_audio_config(key):
    a = CONFIG["audio_config"]
    assert a[key] == PUBLISHED_AUDIO[key] and type(a[key]) is type(PUBLISHED_AUDIO[key])


def test_config_cuts_nothing():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}[CONFIG["name"]]
    assert CONFIG["reduced"] == [] == entry["reduced"]
    assert entry["source"] == CONFIG["source"] and CONFIG["family"] == "qwen3_omni"
    pc = family().port_config(CONFIG)
    assert (pc.decoder.n_layers, pc.decoder.n_experts, pc.decoder.n_experts_per_tok,
            pc.decoder.moe_intermediate_size, pc.decoder.vocab_size) == (48, 128, 8, 768, 152064)
    assert (pc.encoder.n_layers, pc.encoder.d_model, pc.encoder.head_dim,
            pc.encoder.output_dim) == (32, 1280, 64, 2048)


# -- the references ------------------------------------------------------------------

@pytest.mark.parametrize("interleaved", [True, False])
def test_mrope_with_equal_rows_is_the_ports_rope(interleaved):
    """Three equal position rows (an audio-only prompt) give exactly the
    port's NEOX RoPE, whatever the sections."""
    x = torch.randn(40, 4, 128, generator=torch.Generator().manual_seed(5))
    pos = torch.arange(40)
    got = plain.mrope(x, plain.positions(40, "cpu"), 1e6, [24, 20, 20], interleaved)
    assert torch.equal(got, rope_neox(x, pos.to(torch.int32), 1e6))


def test_mrope_sections_pick_their_rows():
    """With the three rows apart, frequency i takes row i % 3 inside the
    interleaved sections and row t past them."""
    D, half = 16, 8
    x = torch.ones(1, 1, D)
    section = [4, 2, 2]
    for j in range(3):
        pos3 = torch.zeros(3, 1, dtype=torch.long)
        pos3[j] = 7
        y = plain.mrope(x, pos3, 1e4, section, True)
        moved = (y[0, 0, :half] != 1).nonzero().flatten().tolist()
        want = [i for i in range(half)
                if (j == 0 and not (i % 3 and i < 3 * section[i % 3]))
                or (j and i % 3 == j and i < 3 * section[j])]
        assert moved == want, (j, moved, want)


def test_the_two_reference_copies_agree():
    """The benchmark's layer-by-layer reference and the tests' whole-tree one
    give the same logits on the same weights and audio."""
    from asrbench.check import Job
    from asrbench.reference import mel as rmel

    cfg, fam = tiny_cfg(), family()
    samples = pcm(4)
    n_audio = plain.conv_rows(100) * 2 + plain.conv_rows(
        rmel.n_mel_frames(len(samples)) - 200)
    tokens, off = fam.prompt(cfg, "asr", type("R", (), {"n_samples": len(samples)})())
    assert tokens.count(cfg["tokens"]["audio_pad"]) == n_audio
    tokens = tokens + [7, 8, 9]
    rows = slice(len(tokens) - 4, len(tokens))
    (bench, low), = fam.reference(cfg, 11, "cpu", [Job(samples, tokens, off, rows)], control=True)
    whole = plain.forward(weights(cfg, 11, torch.float32), cfg,
                          rmel.log_mel(samples, "cpu"), tokens, off)[rows]
    assert torch.equal(bench, whole)
    assert not torch.equal(low, bench)   # the control's int4 experts


# -- the port against the reference ----------------------------------------------------

@pytest.mark.parametrize("seed,kv", [(1, "bf16"), (2, "bf16"), (3, "int8"), (4, "int8")])
def test_port_matches_the_plain_reference(seed, kv):
    """The prefill's last row and 8 greedy steps through the cache against
    the reference's one causal pass over the same tokens (logits)."""
    cfg = tiny_cfg()
    asr = port(cfg, weights(cfg, seed), kv)
    got, want = port_and_reference_logits(cfg, asr, weights(cfg, seed, torch.float32),
                                          pcm(seed))
    med, flipped, gap = agreement(got, want)
    assert med < MEDIAN_REL and flipped <= MAX_FLIPPED and gap < MEAN_GAP, (med, flipped, gap)


def _skew(tree: dict) -> None:
    """Routers that send most rows to experts 0 and 1: their columns 20x,
    the others' 0.05x."""
    r = tree["decoder"]["layers"]["router"]
    r[..., :2] *= 20
    r[..., 2:] *= 0.05


def test_skewed_routing_matches_the_reference():
    """Most pairs on two experts (the grouped products' long tiles): the
    port still follows the reference."""
    cfg = tiny_cfg()
    bf, ref = weights(cfg, 5), weights(cfg, 5, torch.float32)
    _skew(bf)
    _skew(ref)
    asr = port(cfg, bf)
    tdec._moe.rows_max = 0
    got, want = port_and_reference_logits(cfg, asr, ref, pcm(5))
    med, flipped, gap = agreement(got, want)
    assert med < MEDIAN_REL and flipped <= MAX_FLIPPED and gap < MEAN_GAP, (med, flipped, gap)
    n_rows = len(build_asr_prompt(39, asr.cfg.decoder))   # 3 s of audio: 39 rows
    assert tdec._moe.stats[1] > n_rows // 2


def test_a_wrong_routing_is_far():
    """The comparison has teeth: the port with its experts' order reversed
    (each row served by other experts) reads far past the tolerance."""
    cfg = tiny_cfg()
    bf = weights(cfg, 1)
    for k in ("experts_gate", "experts_up", "experts_down"):
        bf["decoder"]["layers"][k] = bf["decoder"]["layers"][k].flip(1).contiguous()
    asr = port(cfg, bf)
    got, want = port_and_reference_logits(cfg, asr, weights(cfg, 1, torch.float32), pcm(1))
    med, flipped, _ = agreement(got, want)
    assert med > 3 * REL_L2 and flipped > 0.5, (med, flipped)


def _per_row(xq, sx, router, gu, dn, k, res, w_next, eps):
    """The MoE block row by row, from the definitions: the top k of the
    row's router softmax, each expert's gate-up product, bf16 SwiGLU and its
    codes, the down product weighted; the row's sum in order, the residual
    and the next layer's codes."""
    from qwen3_asr_tpu_torch.models.decoder import rms_norm, silu

    N, H = res.shape
    F = gu["q"].shape[1] // 2
    x = torch.empty_like(res)
    codes = torch.zeros(N, H, dtype=torch.int8)
    scales = torch.empty(N, 1)
    for n in range(N):
        logits = (xq[n].double() @ router.double()).float() * sx[n]
        top, ids = torch.topk(torch.softmax(logits, -1), k)
        w = top / top.sum()
        acc = None
        for j, e in enumerate(ids.tolist()):
            a = (xq[n].double() @ gu["q"][e].double().T)
            g_u = (a.float() * (sx[n] * gu["s"][e])).to(torch.bfloat16)
            aq, asx = quantize_rows((silu(g_u[:F]) * g_u[F:]).float()[None])
            d = (aq[0].double() @ dn["q"][e].double().T).float() * (asx[0] * dn["s"][e])
            term = w[j] * d.to(torch.bfloat16).float()
            acc = term if acc is None else acc + term
        x[n] = res[n] + acc.to(torch.bfloat16)
        q, s = quantize_rows(rms_norm(x[n:n + 1], w_next, eps).float())
        codes[n], scales[n] = q[0], s[0]
    return x, codes, scales


@pytest.mark.parametrize("skewed", [False, True])
def test_grouped_products_equal_the_rows(skewed):
    """route, the grouped gate-up and down products and the combine equal
    the block computed row by row, bit for bit; skewed: 80% of the rows
    route to experts 0 and 1, the rest among 2-5, and experts 6 and 7 get
    no row (an empty expert, a tile past 32 rows)."""
    g = torch.Generator().manual_seed(9)
    N, H, F, E, k, eps = 45, 64, 32, 8, 2, 1e-6
    xq = torch.randint(-127, 128, (N, H), generator=g, dtype=torch.int8)
    router = (torch.randn(H, E, generator=g) * 0.05).to(torch.bfloat16)
    if skewed:
        xq[:, :3] = 127
        xq[36:, :2] = -127
        router[:, :2] = 0
        router[0, 0] = router[1, 1] = 1.0
        router[:, 6:] = 0
        router[2, 6:] = -1.0
    sx = torch.rand(N, 1, generator=g) * 0.01 + 1e-3
    gu = tmoe.expert_leaves(*(torch.randn(E, H, F, generator=g) * 0.3 for _ in range(2)),
                            torch.randn(E, F, H, generator=g) * 0.3)
    gu, dn = gu
    res = (torch.randn(N, H, generator=g) * 3).to(torch.bfloat16)
    w_next = (1 + torch.rand(H, generator=g)).to(torch.bfloat16)
    codes = codes_buffer(N, H, "cpu")
    codes[:N] = xq
    wts, order, off = tmoe.route(codes, sx, router, k)
    work = tmoe.prefill_work(N, H, F, k, "cpu")
    act = tmoe.moe_gate_up(codes, sx, order, off, gu["q"], gu["s"], k, work)
    norm_quant_rows(act, None, eps, work["fq"], work["fs"])
    ys = tmoe.moe_down(work["fq"], work["fs"], order, off, wts, dn["q"], dn["s"], work)
    out_codes, out_sx = codes_buffer(N, H, "cpu"), torch.empty(N, 1)
    x = tmoe.moe_combine(res, ys, k, w_next, eps, out_codes, out_sx)
    want_x, want_codes, want_sx = _per_row(xq, sx, router, gu, dn, k, res, w_next, eps)
    assert torch.equal(x, want_x)
    assert torch.equal(out_codes[:N], want_codes) and torch.equal(out_sx, want_sx)
    counts = torch.diff(off)
    assert int(counts.sum()) == N * k and int(work["stats"][0]) == int((counts > 0).sum())
    if skewed:
        assert counts[6:].tolist() == [0, 0] and int(counts[:2].min()) >= 36
        assert int(work["stats"][1]) == int(counts.max()) > 32


def test_decode_step_follows_the_prefill():
    """The MoE decode step's twin at position p gives the row the prefill
    gives at p (the same logits within the two paths' int8 rounding)."""
    cfg = tiny_cfg()
    asr = port(cfg, weights(cfg, 2))
    dcfg, dec = asr.cfg.decoder, asr.params["decoder"]
    toks = torch.tensor([5, 9, 14, 3, 77, 12, 6, 40], dtype=torch.int32)
    h_full, _ = prefill_hidden(dec, dcfg, toks, 8, None, 0, 0, 128, torch.bfloat16)
    h7, cache = prefill_hidden(dec, dcfg, toks[:7], 7, None, 0, 0, 128, torch.bfloat16)
    kvs = mega_caches(dcfg, cache, torch.bfloat16)
    _, _, step = tmoe.moe_decode_step_ref(dec["moe"], dcfg, toks[7:8], 7, *kvs,
                                          return_logits=True)
    full = lm_logits(dec, dcfg, h_full)
    assert float((step - full).norm() / full.norm()) < 0.05



@pytest.mark.parametrize("kv,pos", [("bf16", 5), ("bf16", 70), ("int8", 5), ("int8", 70)])
def test_attention_half_twin_equals_the_reference_path(thinker, kv, pos):
    """`moe_attn_layer`'s twin, phase by phase on the pack's output-major
    QKV and Wo copies, gives every layer the bits of the reference path the
    step's twin took before it (K1's attention twin, then the FFN norm's
    codes): h1, the codes, their scale and the cache row written at pos;
    and the step launches four kernels a layer, then the head's four."""
    dcfg, pack = thinker.cfg.decoder, thinker.params["decoder"]["moe"]
    L, NKV, S = dcfg.n_layers, dcfg.n_kv_heads, 128
    DKV = NKV * dcfg.head_dim
    g = torch.Generator().manual_seed(pos)
    if kv == "bf16":
        cache = [(torch.randn(L, S, DKV, generator=g) * 2).to(torch.bfloat16)
                 for _ in range(2)] + [None, None]
    else:
        cache = [torch.randint(-100, 101, (L, S, DKV), generator=g, dtype=torch.int8)
                 for _ in range(2)]
        cache += [torch.rand(L, S, NKV, generator=g) * 0.02 + 1e-3 for _ in range(2)]
    a, b = ([t.clone() if t is not None else None for t in cache] for _ in range(2))
    x = _bf(torch.randn(dcfg.hidden_size, generator=g) * 3)
    for l in range(L):
        h1, xq, sx, row = tmoe.moe_attn_layer_ref(pack, dcfg, l, x, pos, *a)
        want = _attention_ref(pack, dcfg, l, x, pos, *b)
        wq, wsx = _quant_row(_bf(rms_norm_f32(want, pack["ffn_norm"][l], dcfg.rms_norm_eps)))
        assert torch.equal(h1, want) and torch.equal(xq, wq) and torch.equal(sx, wsx), l
        assert len(row) == (2 if kv == "bf16" else 4)
        assert all(torch.equal(r, t[l, pos]) for r, t in zip(row, b))
        x = h1
    assert all(torch.equal(s, t) for s, t in zip(a, b) if s is not None)
    assert tmoe.step_kernels(L) == 4 * L + 4

# -- the door: transcribe ----------------------------------------------------------

def test_transcribe_fused_and_staged_agree_and_count():
    """transcribe (fused, the CLI's path, and staged) decodes the thinker
    with the same tokens, and the MoE counters move: pairs as enqueued,
    touched experts and decode steps from the final fetch."""
    cfg = tiny_cfg()
    asr = port(cfg, weights(cfg, 3))
    before = (tdec._moe.pairs, tdec._moe.experts_touched, tdec._moe.decode_steps)
    fused = asr.transcribe(pcm(3), TranscribeParams(max_tokens=6, fused=True,
                                                    print_timing=False))
    staged = asr.transcribe(pcm(3), TranscribeParams(max_tokens=6, prompt_bucket=1,
                                                     print_timing=False))
    assert fused.success and staged.success, (fused.error_msg, staged.error_msg)
    assert fused.tokens == staged.tokens and len(fused.tokens) == 6
    n_prompt = len(build_asr_prompt(39, asr.cfg.decoder))
    L, E, k = 2, 8, 2
    assert tdec._moe.pairs - before[0] == 2 * n_prompt * k * L
    assert 2 <= tdec._moe.experts_touched - before[1] <= 2 * L * E
    assert tdec._moe.decode_steps - before[2] == 2 * 5


# -- every other path raises, naming itself ------------------------------------------

@pytest.fixture(scope="module")
def thinker():
    cfg = tiny_cfg()
    return port(cfg, weights(cfg, 1))


@pytest.mark.parametrize("params,name", [
    (TranscribeParams(max_tokens=4, temperature=0.7, seed=1), "sampled decoding"),
    (TranscribeParams(max_tokens=4, spec_k=2), "speculative decoding"),
    (TranscribeParams(max_tokens=4, print_progress=True), "the streaming decode"),
])
def test_other_decodes_raise(thinker, params, name):
    with pytest.raises(NotImplementedError, match=name):
        thinker.transcribe(pcm(1, 1.0), params)


def test_transcribe_batch_raises(thinker):
    with pytest.raises(NotImplementedError, match="transcribe_batch"):
        thinker.transcribe_batch([pcm(1, 1.0), pcm(2, 1.0)], TranscribeParams(max_tokens=4))


def test_server_closed_batch_raises(thinker):
    from qwen3_asr_tpu_torch.serve import ASRServer

    srv = ASRServer(thinker, TranscribeParams(max_tokens=4), max_batch=2, max_wait_ms=2000)
    try:
        futs = [srv.submit(pcm(s, 1.0)) for s in (1, 2)]
        for f in futs:
            with pytest.raises(NotImplementedError, match="transcribe_batch"):
                f.result(timeout=300)
    finally:
        srv.close()


def test_continuous_engine_raises(thinker):
    from qwen3_asr_tpu_torch.pipeline.engine import ContinuousEngine

    with pytest.raises(NotImplementedError, match="continuous engine"):
        ContinuousEngine(thinker)


@pytest.mark.parametrize("quantize,name", [
    ("int4", "quantize='int4'"), ("q8_0", "quantize='q8_0'"), ("", "quantize=False")])
def test_other_weight_modes_raise(quantize, name):
    cfg = tiny_cfg()
    asr = Qwen3ASR(quantize=quantize, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        asr._finish_load(family().port_config(cfg), weights(cfg, 1), [], [])


def test_the_int4_pack_raises(thinker):
    from qwen3_asr_tpu_torch.ops.megakernel import pack_megakernel_params

    with pytest.raises(NotImplementedError, match="int4 decode pack"):
        pack_megakernel_params(thinker.params["decoder"], thinker.cfg.decoder, int4=True)


def test_the_block_decode_raises(thinker):
    """The per-layer paths (the block decode of the speculative verify, the
    Q8_0 and dense steps) meet the experts and raise: no dense MLP runs in
    their place."""
    dcfg, dec = thinker.cfg.decoder, thinker.params["decoder"]
    cache = tdec.init_kv_cache(dcfg, 16, "cpu", torch.bfloat16)
    x = torch.zeros(2, dcfg.hidden_size, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="per-layer MLP"):
        tdec.decoder_forward(dec, dcfg, x, cache, 6, prefill=False, cache_offset=4)
