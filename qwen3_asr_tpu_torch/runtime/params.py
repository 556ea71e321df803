"""Model parameters as dictionaries of torch tensors.

Port of qwen3_asr_tpu/runtime/params.py. The trees keep the JAX package's
keys and layouts ([in, out] linears, OIHW convs, weights stacked along a
leading layer axis, `{"i8pc:q", "i8pc:s"}` leaves for int8pc weights,
`{"q8:q", "q8:s"}` leaves for Q8_0 weights and the padded `lm_head_q8`), so a
tree from either package converts to the other leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import (
    AlignerModelConfig,
    ASRModelConfig,
    AudioEncoderConfig,
    DecoderConfig,
)
from qwen3_asr_tpu_torch.ops.q8_matmul import (
    dequantize_q8_weights,
    quant_leaf,
    quantize_pc_weights,
    quantize_q8_weights,
)

_DEC_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# conversion and residency
# ---------------------------------------------------------------------------

def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included) -> torch tensor."""
    a = np.array(a)  # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def from_jax_params(tree: dict, cfg: ASRModelConfig | AlignerModelConfig,
                    device="cpu", int4: bool = True) -> dict:
    """The JAX package's ASR or aligner parameter tree, as numpy arrays (the
    dense tree of `init_asr_params` / `init_aligner_params`, or one whose
    decoder went through `quantize_decoder_params('int8pc' or 'q8_0')` and
    `fuse_decoder_params`, Q8_0 leaves and `lm_head_q8` included; an
    aligner's `classify_w` / `classify_b` carried across as they are) ->
    the port's tree on `device`.
    An int8pc, fused decoder also gets the decode pack (`dec["mega"]`),
    built from its int8pc leaves as the JAX package's
    `pack_megakernel_params(int4=int4)` builds it."""
    out = _map(tree, lambda a: to_torch(a, device))
    dec = out["decoder"]
    if "lm_head_pc" in dec and "wqkv" in dec["layers"]:
        from qwen3_asr_tpu_torch.ops.megakernel import pack_megakernel_params

        dec["mega"] = pack_megakernel_params(dec, cfg.decoder, int4=int4)
    return out


def assert_on_device(tree, device) -> None:
    """Raise unless every tensor leaf of `tree` lives on `device` — the
    port's `ship_to_device` check (weights left on the host make every step
    copy them again)."""
    device = torch.device(device)
    bad = []

    def visit(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                visit(v, f"{path}/{k}")
        elif isinstance(t, torch.Tensor) and t.device.type != device.type:
            bad.append(f"{path} on {t.device}")

    visit(tree, "")
    if bad:
        raise RuntimeError(f"{len(bad)} tensors not on {device}: "
                           + ", ".join(bad[:4]))


# ---------------------------------------------------------------------------
# quantization and fusion
# ---------------------------------------------------------------------------

def resolve_quantize(quantize: str, dec_params: dict) -> str:
    """A weight mode for this decoder: "auto" -> "int8pc" for dense
    weights, "" when the GGUF already shipped int8 blocks (quantized leaves
    are dicts); any other mode as it is."""
    if quantize != "auto":
        return quantize
    already = any(isinstance(dec_params["layers"].get(k), dict) for k in _DEC_QUANT_KEYS)
    return "" if already else "int8pc"


def quantize_decoder_params(dec_params: dict, mode: str = "int8pc",
                            lm_head: bool = True) -> dict:
    """int8 leaves for the per-layer matmul weights (leaves that are already
    quantized, as a Q8_0 GGUF loads them, stay) and an int8 copy of the
    lm head (the tied embedding, or an untied `lm_head` [hidden, vocab]).
    mode="int8pc": per-output-channel leaves and `lm_head_pc` [hidden,
    vocab]; an MoE decoder's dense experts (`experts_gate`, `experts_up`
    [L, E, hidden, F], `experts_down` [L, E, F, hidden]) become the int8
    expert leaves of `ops/moe.py`; mode="q8_0": Q8_0 leaves (per-32-row-block
    scales, codes bit-equal to the reference's numpy quantizer) and
    `lm_head_q8`, its vocab zero-padded to a multiple of 4,096. lm_head=False
    leaves the head dense: the aligner ends in its classify head and would
    never read an int8 copy of the 152k-row table."""
    if mode not in ("int8pc", "q8_0"):
        raise NotImplementedError(f"quantize mode {mode!r} is not ported "
                                  "(only 'int8pc' and 'q8_0')")
    out = dict(dec_params)
    layers = dict(dec_params["layers"])
    if "experts_gate" in layers:
        if mode != "int8pc":
            raise NotImplementedError(f"quantize mode {mode!r} for an MoE decoder: "
                                      "its experts run int8pc only")
        from qwen3_asr_tpu_torch.ops.moe import expert_leaves

        layers["experts_gu"], layers["experts_down"] = expert_leaves(
            layers.pop("experts_gate"), layers.pop("experts_up"), layers["experts_down"])
    for key in _DEC_QUANT_KEYS:
        if key not in layers or isinstance(layers[key], dict):
            continue
        if mode == "int8pc":
            q, s = quantize_pc_weights(layers[key])
            layers[key] = {"i8pc:q": q, "i8pc:s": s}
            continue
        qs, ss = zip(*(quantize_q8_weights(w) for w in layers[key]))
        layers[key] = {"q8:q": torch.stack(qs), "q8:s": torch.stack(ss)}
    out["layers"] = layers
    if not lm_head:
        return out
    def head():   # [hidden, vocab]
        return (dec_params["lm_head"] if "lm_head" in dec_params
                else dec_params["token_embd"].T).float()

    if mode == "int8pc" and "lm_head_pc" not in out:
        q, s = quantize_pc_weights(head())
        out["lm_head_pc"] = {"i8pc:q": q.contiguous(), "i8pc:s": s}
    elif mode == "q8_0" and "lm_head_q8" not in out:
        out["lm_head_q8"] = quant_leaf(head(), pad_out_to=4096)
    out.pop("lm_head", None)   # the int8 copy replaces an untied head
    return out


def dequantize_decoder_params(dec_params: dict, dtype=torch.bfloat16) -> dict:
    """Q8_0 leaves (a natively loaded Q8_0 GGUF) back to dense matrices in
    `dtype`: the input of the int8pc / int4 quantizers."""
    layers = dict(dec_params["layers"])
    for key in _DEC_QUANT_KEYS:
        leaf = layers.get(key)
        if isinstance(leaf, dict) and "q8:q" in leaf:
            layers[key] = torch.stack([
                dequantize_q8_weights(q, s).to(dtype)
                for q, s in zip(leaf["q8:q"], leaf["q8:s"])])
    return dict(dec_params, layers=layers)


def fuse_decoder_params(dec_params: dict) -> dict:
    """Concatenate wq|wk|wv into `wqkv` and w_gate|w_up into `w_gate_up`
    along the output axis (bit-identical outputs)."""
    layers = dict(dec_params["layers"])

    def cat(keys):
        vals = [layers[k] for k in keys]
        kinds = [isinstance(v, dict) for v in vals]
        if all(kinds):
            if any(v.keys() != vals[0].keys() for v in vals):
                return None
            return {k: torch.cat([v[k] for v in vals], dim=-1)
                    for k in vals[0]}
        if any(kinds):
            return None
        return torch.cat(vals, dim=-1)

    for fused, keys in (("wqkv", ("wq", "wk", "wv")),
                        ("w_gate_up", ("w_gate", "w_up"))):
        if all(k in layers for k in keys):
            val = cat(keys)
            if val is not None:
                layers[fused] = val
                for k in keys:
                    del layers[k]
    out = dict(dec_params)
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# random init (benchmarks and tests without model files)
# ---------------------------------------------------------------------------

def _normal(gen, shape, scale, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_encoder_params(cfg: AudioEncoderConfig, gen, dtype, device) -> dict:
    d, f, c, L = cfg.d_model, cfg.ffn_dim, cfg.conv_channels, cfg.n_layers

    def nrm(*shape, scale=0.02):
        return _normal(gen, shape, scale, dtype, device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def o(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    f32 = torch.float32
    layers = {
        "attn_norm_w": o(L, d), "attn_norm_b": z(L, d),
        "wq": nrm(L, d, d), "bq": z(L, d),
        "wk": nrm(L, d, d), "bk": z(L, d),
        "wv": nrm(L, d, d), "bv": z(L, d),
        "wo": nrm(L, d, d), "bo": z(L, d),
        "ffn_norm_w": o(L, d), "ffn_norm_b": z(L, d),
        "w_up": nrm(L, d, f), "b_up": z(L, f),
        "w_down": nrm(L, f, d), "b_down": z(L, d),
    }
    return {
        "conv1_w": _normal(gen, (c, 1, 3, 3), 0.1, f32, device),
        "conv1_b": torch.zeros(c, dtype=f32, device=device),
        "conv2_w": _normal(gen, (c, c, 3, 3), 0.02, f32, device),
        "conv2_b": torch.zeros(c, dtype=f32, device=device),
        "conv3_w": _normal(gen, (c, c, 3, 3), 0.02, f32, device),
        "conv3_b": torch.zeros(c, dtype=f32, device=device),
        "conv_out_w": nrm(cfg.conv_out_in_dim, d),
        "layers": layers,
        "ln_post_w": o(d), "ln_post_b": z(d),
        "proj1_w": nrm(d, d), "proj1_b": z(d),
        "proj2_w": nrm(d, cfg.output_dim), "proj2_b": z(cfg.output_dim),
    }


def init_decoder_params(cfg: DecoderConfig, gen, dtype, device) -> dict:
    h, L = cfg.hidden_size, cfg.n_layers
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size

    def nrm(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def o(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    out = {
        "token_embd": nrm(cfg.vocab_size, h),
        "output_norm": o(h),
        "layers": {
            "attn_norm": o(L, h),
            "wq": nrm(L, h, qd), "wk": nrm(L, h, kvd), "wv": nrm(L, h, kvd),
            "wo": nrm(L, qd, h),
            "q_norm": o(L, cfg.head_dim), "k_norm": o(L, cfg.head_dim),
            "ffn_norm": o(L, h),
        },
    }
    layers = out["layers"]
    if cfg.moe:   # the router, the experts and an untied head
        E, F = cfg.n_experts, cfg.moe_intermediate_size
        layers.update(router=nrm(L, h, E), experts_gate=nrm(L, E, h, F),
                      experts_up=nrm(L, E, h, F), experts_down=nrm(L, E, F, h))
        out["lm_head"] = nrm(h, cfg.vocab_size)
    else:
        layers.update(w_gate=nrm(L, h, inter), w_up=nrm(L, h, inter),
                      w_down=nrm(L, inter, h))
    if cfg.classify_num is not None:
        out["classify_w"] = nrm(h, cfg.classify_num)
        out["classify_b"] = torch.zeros(cfg.classify_num, dtype=dtype, device=device)
    return out


def init_asr_params(cfg: ASRModelConfig, seed: int = 0, device="cpu",
                    dtype=torch.bfloat16) -> dict:
    """Synthetic weights at the config's full size from a seeded
    torch.Generator on `device` (the JAX package's init shapes and scales;
    not its numbers, which come from JAX's own generator)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "encoder": init_encoder_params(cfg.encoder, gen, dtype, device),
        "decoder": init_decoder_params(cfg.decoder, gen, dtype, device),
    }


def init_aligner_params(cfg: AlignerModelConfig, seed: int = 0, device="cpu",
                        dtype=torch.bfloat16) -> dict:
    """Synthetic aligner weights (the windowed encoder, the decoder with its
    classify head), as init_asr_params makes them."""
    return init_asr_params(cfg, seed, device, dtype)


# ---------------------------------------------------------------------------
# GGUF loading
# ---------------------------------------------------------------------------

def load_asr_model(path: str, device="cpu", dtype=torch.bfloat16):
    """GGUF file -> (ASRModelConfig, params, vocab, merges). A decoder
    matmul weight stored as Q8_0 in every layer loads its GGML blocks
    directly as a Q8_0 leaf (no requantization); other Q8_0 tensors are
    decoded to float."""
    return _load_model(path, device, dtype, aligner=False)


def load_aligner_model(path: str, device="cpu", dtype=torch.bfloat16):
    """Forced-aligner GGUF -> (AlignerModelConfig, params, vocab, merges):
    the windowed encoder, the decoder and its classify head
    (`classify_head.weight` / `.bias`, or `output.weight` without a bias,
    as the reference's loader names it)."""
    return _load_model(path, device, dtype, aligner=True)


def _load_model(path: str, device, dtype, aligner: bool):
    from qwen3_asr_tpu_torch.runtime.gguf import GGML_TYPE_Q8_0, GGUFFile

    g = GGUFFile(path)
    try:
        cfg = _config_from_gguf(g, aligner)
        enc_cfg, dec_cfg = cfg.encoder, cfg.decoder

        def get(name, dt=dtype, transpose=False):
            a = np.asarray(g.get(name), np.float32)
            return to_torch(a.T if transpose else a, device).to(dt)

        def maybe(name, transpose=False):
            return get(name, transpose=transpose) if name in g.tensors else None

        def stack(fmt, n, transpose):
            mats = [np.asarray(g.get(fmt.format(i)), np.float32) for i in range(n)]
            a = np.stack([m.T if transpose else m for m in mats])
            return to_torch(a, device).to(dtype)

        def matmul_weight(fmt, n):
            """[L, in, out], or a Q8_0 leaf of GGML's own blocks: they run
            along ne[0] (`in`), so the (out, in) numpy view transposes to
            the leaf's [in, out] / [in/32, out] layout."""
            names = [fmt.format(i) for i in range(n)]
            if not all(g.tensors[m].ggml_type == GGML_TYPE_Q8_0 for m in names):
                return stack(fmt, n, True)
            qs, ss = [], []
            for m in names:
                q_flat, s_flat = g.get_q8_0(m)
                out_dim, in_dim = tuple(reversed(g.tensors[m].shape))[:2]
                qs.append(q_flat.reshape(out_dim, in_dim).T)
                ss.append(s_flat.reshape(out_dim, in_dim // 32).T.astype(np.float32))
            return {"q8:q": to_torch(np.stack(qs), device),
                    "q8:s": to_torch(np.stack(ss), device)}

        p = "audio.encoder."
        enc_layers = {
            key: stack(p + "blk.{}." + name, enc_cfg.n_layers, tr)
            for key, name, tr in (
                ("attn_norm_w", "attn_norm.weight", False),
                ("attn_norm_b", "attn_norm.bias", False),
                ("wq", "attn_q.weight", True), ("bq", "attn_q.bias", False),
                ("wk", "attn_k.weight", True), ("bk", "attn_k.bias", False),
                ("wv", "attn_v.weight", True), ("bv", "attn_v.bias", False),
                ("wo", "attn_out.weight", True), ("bo", "attn_out.bias", False),
                ("ffn_norm_w", "ffn_norm.weight", False),
                ("ffn_norm_b", "ffn_norm.bias", False),
                ("w_up", "ffn_up.weight", True), ("b_up", "ffn_up.bias", False),
                ("w_down", "ffn_down.weight", True),
                ("b_down", "ffn_down.bias", False),
            )
        }
        f32 = torch.float32
        encoder = {
            **{f"conv{i}_{s}": get(f"{p}conv{i}.{n}", f32)
               for i in (1, 2, 3) for s, n in (("w", "weight"), ("b", "bias"))},
            "conv_out_w": get(p + "conv_out.weight", transpose=True),
            "layers": enc_layers,
            "ln_post_w": maybe(p + "ln_post.weight"),
            "ln_post_b": maybe(p + "ln_post.bias"),
            "proj1_w": maybe(p + "proj1.weight", transpose=True),
            "proj1_b": maybe(p + "proj1.bias"),
            "proj2_w": maybe(p + "proj2.weight", transpose=True),
            "proj2_b": maybe(p + "proj2.bias"),
        }
        dec_layers = {
            key: stack("blk.{}." + name, dec_cfg.n_layers, False)
            for key, name in (
                ("attn_norm", "attn_norm.weight"),
                ("q_norm", "attn_q_norm.weight"),
                ("k_norm", "attn_k_norm.weight"),
                ("ffn_norm", "ffn_norm.weight"),
            )
        }
        dec_layers.update({
            key: matmul_weight("blk.{}." + name, dec_cfg.n_layers)
            for key, name in (
                ("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
                ("wv", "attn_v.weight"), ("wo", "attn_output.weight"),
                ("w_gate", "ffn_gate.weight"), ("w_up", "ffn_up.weight"),
                ("w_down", "ffn_down.weight"),
            )
        })
        decoder = {
            "token_embd": get("token_embd.weight"),
            "output_norm": get("output_norm.weight"),
            "layers": dec_layers,
        }
        if dec_cfg.classify_num is not None:
            if "classify_head.weight" in g.tensors:
                decoder["classify_w"] = get("classify_head.weight", transpose=True)
                decoder["classify_b"] = maybe("classify_head.bias")
            else:
                decoder["classify_w"] = get("output.weight", transpose=True)
                decoder["classify_b"] = None
        vocab = list(g.metadata.get("tokenizer.ggml.tokens", []))
        merges = list(g.metadata.get("tokenizer.ggml.merges", []))
    finally:
        g.close()
    return cfg, {"encoder": encoder, "decoder": decoder}, vocab, merges


def decoder_config_from_gguf(g, classify: bool) -> DecoderConfig:
    """Decoder hyperparameters from GGUF metadata, with the JAX loader's
    keys and defaults (qwen3_asr_tpu/runtime/params.py::
    decoder_config_from_gguf): an aligner (classify=True) defaults to vocab
    152,064 and reads `qwen3-asr.classify_num` (default 5,000)."""
    md = g.metadata

    def get(key, default):
        return type(default)(md.get(key, default))

    d = DecoderConfig()
    return DecoderConfig(
        vocab_size=get("qwen3-asr.vocab_size", 152064 if classify else d.vocab_size),
        hidden_size=get("qwen3-asr.embedding_length", d.hidden_size),
        n_layers=get("qwen3-asr.block_count", d.n_layers),
        n_heads=get("qwen3-asr.attention.head_count", d.n_heads),
        n_kv_heads=get("qwen3-asr.attention.head_count_kv", d.n_kv_heads),
        intermediate_size=get("qwen3-asr.feed_forward_length", d.intermediate_size),
        head_dim=get("qwen3-asr.attention.key_length", d.head_dim),
        rms_norm_eps=get("qwen3-asr.attention.layer_norm_rms_epsilon", d.rms_norm_eps),
        rope_theta=get("qwen3-asr.rope.freq_base", d.rope_theta),
        audio_start_token_id=get("qwen3-asr.audio.start_token_id", d.audio_start_token_id),
        audio_end_token_id=get("qwen3-asr.audio.end_token_id", d.audio_end_token_id),
        audio_pad_token_id=get("qwen3-asr.audio.pad_token_id", d.audio_pad_token_id),
        eos_token_id=get("tokenizer.ggml.eos_token_id", d.eos_token_id),
        pad_token_id=get("tokenizer.ggml.padding_token_id", d.pad_token_id),
        im_start_token_id=get("qwen3-asr.chat.im_start_token_id", d.im_start_token_id),
        im_end_token_id=get("qwen3-asr.chat.im_end_token_id", d.im_end_token_id),
        system_token_id=get("qwen3-asr.chat.system_token_id", d.system_token_id),
        user_token_id=get("qwen3-asr.chat.user_token_id", d.user_token_id),
        assistant_token_id=get("qwen3-asr.chat.assistant_token_id", d.assistant_token_id),
        newline_token_id=get("qwen3-asr.chat.newline_token_id", d.newline_token_id),
        classify_num=get("qwen3-asr.classify_num", 5000) if classify else None,
    )


def encoder_config_from_gguf(g, output_dim: int, aligner: bool) -> AudioEncoderConfig:
    """Encoder hyperparameters from GGUF metadata; an aligner's defaults are
    AlignerModelConfig's (24 x d 1,024, windows of 800 mel frames)."""
    md = g.metadata

    def get(key, default):
        return type(default)(md.get(key, default))

    e = AlignerModelConfig().encoder if aligner else AudioEncoderConfig()
    return AudioEncoderConfig(
        n_layers=get("qwen3-asr.audio.encoder.layer_count", e.n_layers),
        d_model=get("qwen3-asr.audio.encoder.embedding_length", e.d_model),
        n_heads=get("qwen3-asr.audio.encoder.attention.head_count", e.n_heads),
        ffn_dim=get("qwen3-asr.audio.encoder.feed_forward_length", e.ffn_dim),
        conv_channels=get("qwen3-asr.audio.conv_channels", e.conv_channels),
        n_mel_bins=get("qwen3-asr.audio.num_mel_bins", e.n_mel_bins),
        output_dim=output_dim,
        n_window_infer=e.n_window_infer,
    )


def is_aligner_gguf(g) -> bool:
    """Aligner GGUFs carry classify metadata and/or a classify head tensor."""
    return ("qwen3-asr.classify_num" in g.metadata
            or "classify_head.weight" in g.tensors)


def _config_from_gguf(g, aligner: bool = False):
    """ASRModelConfig, or with aligner=True AlignerModelConfig (its
    timestamp token and segment length read too), from GGUF metadata."""
    dec = decoder_config_from_gguf(g, classify=aligner)
    enc = encoder_config_from_gguf(g, dec.hidden_size, aligner)
    if not aligner:
        return ASRModelConfig(encoder=enc, decoder=dec)
    md = g.metadata
    return AlignerModelConfig(
        encoder=enc, decoder=dec,
        timestamp_token_id=int(md.get("qwen3-asr.timestamp_token_id", 151705)),
        timestamp_segment_time_ms=int(md.get("qwen3-asr.timestamp_segment_time", 80)))
