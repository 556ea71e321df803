"""Qwen3 text decoder: the prompt prefill and the single-token decode step.

Port of qwen3_asr_tpu/models/decoder.py: `rms_norm`, `rope_neox`,
`init_kv_cache` (bf16 rows, or int8 rows + per-(row, head) f32 scales),
`_quantize_kv_rows`, `embed_with_audio`, `_cached_attention`,
`decoder_forward` (the prefill; the decode step at T = 1 through the
decode-attention kernel; and the block decode of T >= 1 rows at any cache
offset), `decoder_prefill_batch`, `lm_logits` / `lm_logits_block`, and the
aligner's `classify_logits`; and `decode_step_batch`, the decode step at T
= 1 of B sequences in lockstep, each at its own position in its own cache
slab (the reference's `decoder_forward` under `jax.vmap` in its batched
per-layer decode).

The layers take the fused weight layout (`wqkv`, `w_gate_up`) with dense
bf16 matrices, Q8_0 leaves or int8pc leaves:
- Q8_0: QKV through `q8_norm_matmul` (K6), Wo through `q8_matmul` (K5) and
  the MLP through `q8_mlp` (K7), as the reference runs them on the TPU;
  above 256 rows those wrappers run the reference's dequantize-and-dot;
- dense: RMSNorm then plain matrix products, as the reference leaves them
  to XLA;
- int8pc: the W8A8 products of `pc_matmul` (the block decode; the decode
  pack's steps run through `ops/megakernel.py`). The prefill of bf16 rows
  on int8pc leaves runs `_prefill_fused`: `torch._int_mm` on int8 codes and
  the four fused passes of `ops/prefill_fused.py` around it (norm and row
  quantization, dequantization with QK-norm and RoPE, residual, SwiGLU),
  about ten launches a layer and no host wait, at the eager chain's
  rounding points.
An MoE decoder (`config.MoeDecoderConfig`, Qwen3-Omni's thinker) has int8pc
attention and the int8 experts of `ops/moe.py` in every layer: its
prefill is `_prefill_fused` with `_moe` in place of the dense MLP (the
router and the sort of the pairs on the device, the grouped expert
products, the residual pass), its decode steps are `ops/moe.py`'s; every
path with a dense MLP raises for it (`DecoderConfig.require_dense`).
Attention in the prefill is the flash kernel (`ops/flash_attention.py`),
causal with the prompt's valid length; in the decode step it is
`ops/decode_attention.py` (K4; B rows in one launch in the batched step);
in the block decode (the speculative verify pass, int8pc decode steps) and
wherever `use_decode_attn_kernel` is False it is plain torch,
`_cached_attention`, as the reference computes it in XLA.

Cache layout at the public functions is the JAX package's: k/v [L, S, n_kv,
head_dim] bf16 or int8, and for int8 k_s/v_s [L, S, n_kv] f32. The batched
step's cache of B slabs is the batched decode megakernel's pool
(`models/generate.py::prefill_batch_mega_cache`): k/v [B, L, S, n_kv *
head_dim], scales [B, L, S, n_kv]; layer l's slabs are k[:, l], one stride
apart, which the batched decode-attention kernel reads as they lie.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import MOE_PATHS, DecoderConfig
from qwen3_asr_tpu_torch.ops.decode_attention import (
    _quantize_kv_rows,
    decode_attention,
    decode_attention_batch,
    store_kv_rows,
)
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
from qwen3_asr_tpu_torch.ops.moe import (
    moe_combine,
    moe_down,
    moe_gate_up,
    prefill_work,
    route,
)
from qwen3_asr_tpu_torch.ops.prefill_fused import (
    codes_buffer,
    norm_quant_rows,
    qkv_epilogue,
    residual_norm_quant,
    swiglu_quant,
)
from qwen3_asr_tpu_torch.ops.q8_matmul import (
    int8_matmul,
    is_pc_leaf,
    is_quant_leaf,
    matmul_any,
    q8_mlp,
    q8_norm_matmul,
)
from qwen3_asr_tpu_torch.runtime.profiler import span


def rms_norm(x: torch.Tensor, w: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.float()
    y = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    return y if w is None else y * w


@functools.cache
def rope_inv_freq(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """The NEOX rotary embedding's frequencies 1 / theta^(2i / d), f32 [d / 2]
    on `device`, computed in float64 on the host and copied once per (d,
    theta, device): no later call waits on a host copy."""
    inv = 1.0 / (theta ** (np.arange(0, d // 2, dtype=np.float64) * 2.0 / d))
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def rope_tables(positions: torch.Tensor, inv_freq: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The NEOX rotary embedding's cos and sin [T, 1, d/2] f32 at positions,
    for the frequencies inv_freq [d/2] of `rope_inv_freq`."""
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, n_heads, head_dim] rotated by rope_tables' cos and sin: pairs
    (x[i], x[i+d/2])."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_neox(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NEOX rotary embedding on [T, n_heads, head_dim]: pairs (x[i], x[i+d/2])."""
    inv_freq = rope_inv_freq(x.shape[-1], float(theta), positions.device)
    return apply_rope(x, *rope_tables(positions, inv_freq))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))) with every op in x's dtype: in bf16 this
    rounds after each op, as jax.nn.silu does (F.silu rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_kv_cache(cfg: DecoderConfig, n_ctx: int, device,
                  dtype: torch.dtype = torch.int8) -> dict:
    """Zeroed cache [L, n_ctx, n_kv, head_dim] of `dtype` (bf16 or int8); an
    int8 cache also holds per-(row, head) f32 scales [L, n_ctx, n_kv]."""
    if dtype not in (torch.int8, torch.bfloat16):
        raise NotImplementedError(f"KV cache dtype {dtype}: the port has "
                                  "bf16 and int8 caches")
    shape = (cfg.n_layers, n_ctx, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_s"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
        cache["v_s"] = torch.zeros(shape[:3], dtype=torch.float32, device=device)
    return cache


def _store(cache: dict, l: int, rows, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V rows ([n, n_kv, hd] for a slice of rows, [n_kv, hd] for one
    row index) into layer l's cache rows `rows`, in the cache's format
    (`store_kv_rows`, the decode-attention kernel's store); in the batched
    cache [B, L, S, n_kv * hd] rows = (slabs, positions), index tensors [B],
    with k [B, n_kv, hd]. The prefill and the block decode store here; the
    decode steps' kernel stores its own rows."""
    layer = (lambda t: t[:, l]) if isinstance(rows, tuple) else (lambda t: t[l])
    store_kv_rows(*(layer(cache[n]) if n in cache else None
                    for n in ("k", "v", "k_s", "v_s")), rows, k, v)


def embed_with_audio(dec_params: dict, tokens: torch.Tensor,
                     audio: torch.Tensor | None, n_audio: int,
                     audio_offset: int) -> torch.Tensor:
    """Token embeddings with the encoder rows spliced over the audio_pad
    rows [audio_offset, audio_offset + n_audio)."""
    h = dec_params["token_embd"][tokens]
    if audio is None:
        return h
    h = h.clone()
    h[audio_offset:audio_offset + n_audio] = audio[:n_audio].to(h.dtype)
    return h


def _leaf(layers: dict, key: str, l: int):
    w = layers[key]
    return {k: v[l] for k, v in w.items()} if isinstance(w, dict) else w[l]


def _qkv(layers: dict, l: int, x: torch.Tensor, eps: float) -> torch.Tensor:
    """The fused QKV rows of layer l for x [N, hidden], in x's dtype."""
    w = _leaf(layers, "wqkv", l)
    if is_quant_leaf(w):   # the norm fused into the int8 kernel
        return q8_norm_matmul(x, w, layers["attn_norm"][l], eps).to(x.dtype)
    return matmul_any(rms_norm(x, layers["attn_norm"][l], eps), w)


def _mlp(layers: dict, l: int, h1: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """h1 + the SwiGLU MLP of layer l, h1 [N, hidden]."""
    cfg.require_dense("the per-layer MLP (the block decode, Q8_0 and dense steps)")
    eps = cfg.rms_norm_eps
    gu, down = _leaf(layers, "w_gate_up", l), _leaf(layers, "w_down", l)
    if is_quant_leaf(gu) and is_quant_leaf(down):   # the whole MLP in K7
        return h1 + q8_mlp(h1, gu, down, layers["ffn_norm"][l], eps,
                           cfg.intermediate_size).to(h1.dtype)
    g_u = matmul_any(rms_norm(h1, layers["ffn_norm"][l], eps), gu)
    ffn = g_u.shape[-1] // 2
    return h1 + matmul_any(silu(g_u[:, :ffn]) * g_u[:, ffn:], down)


_PC_MATRICES = ("wqkv", "wo", "w_gate_up", "w_down")


def _fusable(layers: dict, h: torch.Tensor) -> bool:
    """Whether `_prefill_layers` takes the fused chain: bf16 rows on int8pc
    leaves (the fused passes' kernels take bf16); an MoE layer's experts are
    int8 leaves of their own (`ops/moe.py`)."""
    names = _PC_MATRICES[:2] if "experts_gu" in layers else _PC_MATRICES
    return h.dtype == torch.bfloat16 and all(is_pc_leaf(layers.get(n)) for n in names)


def _prefill_layers(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    valid: torch.Tensor, on_rows) -> torch.Tensor:
    """The prefill's layer stack on prompt blocks h [B, P, hidden]: every
    matmul runs once on the flattened [B * P] rows, attention is the flash
    kernel, causal, keys at index >= valid[b] masked. Calls on_rows(l, k, v)
    with each layer's fresh rows [B, P, n_kv, head_dim] in h's dtype;
    returns the hidden states [B, P, hidden]. A `_fusable` stack takes the
    fused chain (`_prefill_fused`), counted in `.fused_layers`; every other
    runs op by op, counted in `.eager_layers`."""
    layers = dec_params["layers"]
    if cfg.moe and not _fusable(layers, h):
        raise NotImplementedError(f"the MoE prefill runs bf16 rows on int8pc weights: "
                                  f"{MOE_PATHS}")
    if _fusable(layers, h):
        _prefill_layers.fused_layers += cfg.n_layers
        return _prefill_fused(layers, cfg, h, valid, on_rows)
    _prefill_layers.eager_layers += cfg.n_layers
    B, P, H = h.shape
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv = NH * D, NKV * D
    scale = 1.0 / float(np.sqrt(D))
    positions = torch.arange(P, device=h.device, dtype=torch.int32)
    eps = cfg.rms_norm_eps
    x = h.reshape(B * P, H)
    for l in range(cfg.n_layers):
        qkv = _qkv(layers, l, x, eps).reshape(B, P, -1)
        q = qkv[..., :dq].reshape(B, P, NH, D)
        k = qkv[..., dq:dq + dkv].reshape(B, P, NKV, D)
        v = qkv[..., dq + dkv:].reshape(B, P, NKV, D)
        q = rope_neox(rms_norm(q, layers["q_norm"][l], eps), positions, cfg.rope_theta)
        k = rope_neox(rms_norm(k, layers["k_norm"][l], eps), positions, cfg.rope_theta)
        attn = flash_attention_batch(q, k, v, valid, causal=True, scale=scale)
        h1 = x + matmul_any(attn.reshape(B * P, dq), _leaf(layers, "wo", l))
        x = _mlp(layers, l, h1, cfg)
        on_rows(l, k, v)
    return x.reshape(B, P, H)


_prefill_layers.fused_layers = 0
_prefill_layers.eager_layers = 0


def _prefill_fused(layers: dict, cfg: DecoderConfig, h: torch.Tensor,
                   valid: torch.Tensor, on_rows) -> torch.Tensor:
    """`_prefill_layers` on int8pc leaves and bf16 rows as a fixed chain a
    layer (`ops/prefill_fused.py`): the int8 products on codes that the
    pass before each one leaves in a padded buffer, and four fused passes
    around them, the same ops at the same rounding points as the eager
    chain; nothing waits on the host."""
    B, P, H = h.shape
    N, L = B * P, cfg.n_layers
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    F, eps, dev = cfg.intermediate_size, cfg.rms_norm_eps, h.device
    scale = 1.0 / float(np.sqrt(D))
    xq, aq = (codes_buffer(N, n, dev) for n in (H, NH * D))
    sx, asx, fsx = (torch.empty(N, 1, dtype=torch.float32, device=dev) for _ in range(3))
    if cfg.moe:
        work = prefill_work(N, H, cfg.moe_intermediate_size, cfg.n_experts_per_tok, dev)
    else:
        fq = codes_buffer(N, F, dev)
    x = h.reshape(N, H)
    inv_freq = rope_inv_freq(D, float(cfg.rope_theta), dev)
    norm_quant_rows(x, layers["attn_norm"][0], eps, xq, sx)
    for l in range(L):
        wqkv, wo = _leaf(layers, "wqkv", l), _leaf(layers, "wo", l)
        q, k, v = qkv_epilogue(int8_matmul(xq, wqkv["i8pc:q"]), sx, wqkv["i8pc:s"],
                               layers["q_norm"][l], layers["k_norm"][l], P, NH, NKV, D,
                               eps, inv_freq)
        attn = flash_attention_batch(q, k, v, valid, causal=True, scale=scale)
        norm_quant_rows(attn.reshape(N, NH * D), None, eps, aq, asx)
        h1 = residual_norm_quant(x, int8_matmul(aq, wo["i8pc:q"]), asx, wo["i8pc:s"],
                                 layers["ffn_norm"][l], eps, xq, sx)
        w_next = layers["attn_norm"][l + 1] if l + 1 < L else None
        if cfg.moe:
            x = _moe(layers, l, cfg, h1, xq, sx, w_next, work)
        else:
            gu, down = _leaf(layers, "w_gate_up", l), _leaf(layers, "w_down", l)
            swiglu_quant(int8_matmul(xq, gu["i8pc:q"]), sx, gu["i8pc:s"], F, fq, fsx)
            x = residual_norm_quant(h1, int8_matmul(fq, down["i8pc:q"]), fsx,
                                    down["i8pc:s"], w_next, eps, xq, sx)
        on_rows(l, k, v)
    if cfg.moe:
        _moe.stats = work["stats"]
    return x.reshape(B, P, H)


def _moe(layers: dict, l: int, cfg: DecoderConfig, h1: torch.Tensor, xq: torch.Tensor,
         sx: torch.Tensor, w_next: torch.Tensor | None, work: dict) -> torch.Tensor:
    """Layer l's experts in the prefill (`ops/moe.py`), on the codes xq / sx
    of RMSNorm(h1) that the residual pass left: the router and the sort of
    the (row, expert) pairs on the device, the grouped gate-up products,
    the SwiGLU rows' codes (F1), the grouped down products, and the
    residual h1 + the weighted expert outputs with the
    next layer's codes (w_next: its attention norm, None after the last
    layer) written over xq / sx. -> x [N, hidden] bf16.

    Counters: `.pairs` the routed (row, expert) pairs, added as the prefill
    is enqueued; `.experts_touched` (the experts with a pair, summed over
    the layers) and `.rows_max` (the most pairs one expert took) from the
    prefill's device counts (`.stats`, int32 [2]), which the greedy loop
    fetches with its tokens; `.decode_steps` the MoE decode steps run."""
    K, eps = cfg.n_experts_per_tok, cfg.rms_norm_eps
    with span("qwen3.moe"):
        wts, order, off = route(xq, sx, layers["router"][l], K)
        gu, dn = _leaf(layers, "experts_gu", l), _leaf(layers, "experts_down", l)
        act = moe_gate_up(xq, sx, order, off, gu["q"], gu["s"], K, work)
        norm_quant_rows(act, None, eps, work["fq"], work["fs"])
        ys = moe_down(work["fq"], work["fs"], order, off, wts, dn["q"], dn["s"], work)
        x = moe_combine(h1, ys, K, w_next, eps, xq, sx)
    _moe.pairs += sx.shape[0] * K
    return x


_moe.pairs = 0
_moe.experts_touched = 0
_moe.rows_max = 0
_moe.decode_steps = 0
_moe.stats = None


def _decode_step(dec_params: dict, cfg: DecoderConfig, x: torch.Tensor,
                 cache: dict, pos: int) -> torch.Tensor:
    """One token x [1, hidden] at position pos through every layer, in the
    reference's order: QKV, the decode-attention kernel over cache rows <
    pos plus the fresh column, bf16, Wo, the residual, the MLP, the
    residual; the kernel stores the fresh K/V row at cache row pos in the
    same launch (store=True). -> [1, hidden]."""
    layers = dec_params["layers"]
    eps = cfg.rms_norm_eps
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    quant = "k_s" in cache
    for l in range(cfg.n_layers):
        qkv = _qkv(layers, l, x, eps)
        attn = decode_attention(
            qkv, cache["k"][l], cache["v"][l], layers["q_norm"][l],
            layers["k_norm"][l], pos, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, eps=eps,
            theta=cfg.rope_theta, scale=scale,
            k_scale=cache["k_s"][l] if quant else None,
            v_scale=cache["v_s"][l] if quant else None, store=True)[0]
        h1 = x + matmul_any(attn.to(x.dtype), _leaf(layers, "wo", l))
        x = _mlp(layers, l, h1, cfg)
    return x


def decode_step_batch(dec_params: dict, cfg: DecoderConfig, x: torch.Tensor,
                      cache: dict, pos: torch.Tensor, pos_host) -> torch.Tensor:
    """One token of each of B sequences, x [B, hidden], through every layer
    in _decode_step's order, row b at position pos[b] over slab b of the
    batched cache (k / v [B, L, S, n_kv * head_dim], int8 with scales [B, L,
    S, n_kv], as prefill_batch_mega_cache fills it): per layer one QKV product, one Wo
    product and one MLP over the B rows (K6 / K5 / K7 at T = B on Q8_0
    leaves, plain products on dense ones), attention through the batched
    decode-attention kernel (each row over its rows < pos[b] plus its fresh
    column), which stores the B fresh K/V rows at their own positions in the
    same launch. pos is int32 [B] on x's device (the kernel reads it there);
    pos_host holds the same positions on the host (the grid's bound).
    use_decode_attn_kernel=False takes the reference's XLA attention
    (`_cached_attention`) row by row instead, and `_store`. -> [B, hidden]."""
    layers = dec_params["layers"]
    B = x.shape[0]
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    eps = cfg.rms_norm_eps
    scale = 1.0 / float(np.sqrt(D))
    quant = "k_s" in cache
    pos_host = [int(p) for p in pos_host]
    if not cfg.use_decode_attn_kernel:   # the rows _store writes
        idx = (torch.arange(B, device=x.device), pos.long())
    for l in range(cfg.n_layers):
        qkv = _qkv(layers, l, x, eps)
        if cfg.use_decode_attn_kernel:
            attn = decode_attention_batch(
                qkv, cache["k"][:, l].unflatten(-1, (NKV, D)),
                cache["v"][:, l].unflatten(-1, (NKV, D)), layers["q_norm"][l],
                layers["k_norm"][l], pos, pos, max(pos_host), n_heads=NH, n_kv=NKV,
                head_dim=D, eps=eps, theta=cfg.rope_theta, scale=scale,
                k_scale=cache["k_s"][:, l] if quant else None,
                v_scale=cache["v_s"][:, l] if quant else None, store=True)[0].to(x.dtype)
        else:
            attn, k_new, v_new = _cached_attention_rows(layers, l, cfg, qkv, cache,
                                                        pos, pos_host, scale)
            _store(cache, l, idx, k_new, v_new)
        h1 = x + matmul_any(attn, _leaf(layers, "wo", l))
        x = _mlp(layers, l, h1, cfg)
    return x


def _cached_attention_rows(layers: dict, l: int, cfg: DecoderConfig, qkv: torch.Tensor,
                           cache: dict, pos: torch.Tensor, pos_host: list,
                           scale: float):
    """The reference's XLA decode attention of layer l for B rows (qkv [B,
    ...]): q and k normed and roped at each row's position, then
    `_cached_attention` of row b over its slab's rows < pos_host[b]
    (dequantized to qkv's dtype) and its fresh column. -> (attn [B, n_heads
    * D], k [B, n_kv, D], v [B, n_kv, D]) in qkv's dtype."""
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv = NH * D, NKV * D
    eps, B = cfg.rms_norm_eps, qkv.shape[0]
    q = qkv[:, :dq].reshape(B, NH, D)
    k = qkv[:, dq:dq + dkv].reshape(B, NKV, D)
    v = qkv[:, dq + dkv:].reshape(B, NKV, D)
    q = rope_neox(rms_norm(q, layers["q_norm"][l], eps), pos, cfg.rope_theta)
    k = rope_neox(rms_norm(k, layers["k_norm"][l], eps), pos, cfg.rope_theta)
    one = torch.ones(1, 1, dtype=torch.bool, device=qkv.device)
    rows = []
    for b, p in enumerate(pos_host):
        kc, vc = (cache[n][b, l, :p].unflatten(-1, (NKV, D)) for n in ("k", "v"))
        if "k_s" in cache:
            kc = (kc.float() * cache["k_s"][b, l, :p, :, None]).to(qkv.dtype)
            vc = (vc.float() * cache["v_s"][b, l, :p, :, None]).to(qkv.dtype)
        rows.append(_cached_attention(q[b:b + 1], kc, vc, k[b:b + 1], v[b:b + 1], one,
                                      scale))
    return torch.cat(rows).reshape(B, dq), k, v


def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      block_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Port of the reference's `_cached_attention`: one softmax over the
    cache rows and this block's fresh K/V. q [T, n_heads, d]; k_cache /
    v_cache [n, n_kv, d], the n cache rows the block may read (the reference
    masks the others, whose probabilities are exact zeros); k_new / v_new [T,
    n_kv, d]; block_mask [T, T] bool. Scores and sums in f32, the
    probabilities rounded to the values' dtype, as the reference does. ->
    [T, n_heads, d] in q's dtype."""
    T, NH, D = q.shape
    NKV = k_new.shape[1]
    n = k_cache.shape[0]
    qg = q.reshape(T, NKV, NH // NKV, D).permute(1, 2, 0, 3).float()   # [kv, g, T, d]
    sc = qg @ k_cache.float().permute(1, 2, 0)[:, None] * scale       # [kv, g, T, n]
    sb = qg @ k_new.float().permute(1, 2, 0)[:, None] * scale         # [kv, g, T, T]
    sb = torch.where(block_mask, sb, float("-inf"))
    p = torch.softmax(torch.cat([sc, sb], dim=-1), dim=-1)
    pc = p[..., :n].to(v_cache.dtype).float()
    pb = p[..., n:].to(v_new.dtype).float()
    out = pc @ v_cache.float().permute(1, 0, 2)[:, None] + pb @ v_new.float().permute(1, 0, 2)[:, None]
    return out.permute(2, 0, 1, 3).reshape(T, NH, D).to(q.dtype)


def _cache_rows_read(offset: int, valid: int) -> int:
    """The cache rows a block at `offset` reads: the reference's cache_mask,
    cols < min(offset, valid). Rows from offset on may hold a draft's
    values."""
    return min(offset, valid)


def _block_decode(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                  cache: dict, offset: int, valid: int) -> torch.Tensor:
    """The reference's non-prefill decoder_forward on a block h [T, hidden]
    at positions offset .. offset + T - 1, plain torch on any leaves (dense,
    Q8_0 through K5-K7, int8pc) and a bf16 or int8 cache: row t attends to
    the cache rows before `_cache_rows_read` (never a draft's), dequantized
    to the activations' dtype,
    and to block rows j <= t with offset + j < valid (a padding row keeps
    its own diagonal). The fresh rows go to cache rows offset .. offset + T
    - 1 after each layer has read its cache, quantized as the prefill's
    are. -> [T, hidden]."""
    T = h.shape[0]
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv = NH * D, NKV * D
    scale = 1.0 / float(np.sqrt(D))
    eps = cfg.rms_norm_eps
    layers = dec_params["layers"]
    dev = h.device
    positions = torch.arange(offset, offset + T, device=dev, dtype=torch.int32)
    rows = torch.arange(T, device=dev)[:, None]
    cols = torch.arange(T, device=dev)[None, :]
    block_mask = (cols <= rows) & ((offset + cols < valid) | (cols == rows))
    cos, sin = rope_tables(positions, rope_inv_freq(D, float(cfg.rope_theta), dev))
    n = _cache_rows_read(offset, valid)
    # the rows every layer reads, dequantized once (the block writes rows >= n)
    kc, vc = cache["k"][:, :n], cache["v"][:, :n]
    if "k_s" in cache:
        kc = (kc.float() * cache["k_s"][:, :n, :, None]).to(h.dtype)
        vc = (vc.float() * cache["v_s"][:, :n, :, None]).to(h.dtype)
    x = h
    for l in range(cfg.n_layers):
        qkv = _qkv(layers, l, x, eps)
        q = qkv[:, :dq].reshape(T, NH, D)
        k = qkv[:, dq:dq + dkv].reshape(T, NKV, D)
        v = qkv[:, dq + dkv:].reshape(T, NKV, D)
        q = apply_rope(rms_norm(q, layers["q_norm"][l], eps), cos, sin)
        k = apply_rope(rms_norm(k, layers["k_norm"][l], eps), cos, sin)
        attn = _cached_attention(q, kc[l], vc[l], k, v, block_mask, scale)
        h1 = x + matmul_any(attn.reshape(T, dq), _leaf(layers, "wo", l))
        x = _mlp(layers, l, h1, cfg)
        _store(cache, l, slice(offset, offset + T), k, v)
    return x


def decoder_forward(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    cache: dict, n_valid: int, prefill: bool = True,
                    cache_offset: int = 0) -> torch.Tensor:
    """Run all layers and write this block's K/V rows into the cache in
    place. Returns the hidden states [T, hidden].

    prefill=True: h [T, hidden] is the prompt block (rows >= n_valid are
    padding) at positions 0 .. T-1; its rows go to cache rows [0, T).
    prefill=False: the block h [T, hidden] at positions cache_offset ..
    cache_offset + T - 1, attending to cache rows < cache_offset and to
    itself causally, its rows written at cache_offset; n_valid is the
    reference's kv_valid_len (cache_offset < n_valid <= cache_offset + T;
    block rows at and past it are padding). One row with n_valid =
    cache_offset + 1 on the fused dense or Q8_0 layout is the decode step
    of the decode-attention kernel (K4); any other block (int8pc leaves, T >
    1: the speculative verify pass; use_decode_attn_kernel=False, the
    reference's XLA attention) runs `_block_decode`.
    """
    if not prefill:
        T, offset = h.shape[0], int(cache_offset)
        if not offset < n_valid <= offset + T:
            raise ValueError(f"kv_valid_len {n_valid} outside (cache_offset, "
                             f"cache_offset + T] = ({offset}, {offset + T}]")
        wqkv = dec_params["layers"]["wqkv"]
        if (T == 1 and n_valid == offset + 1 and not is_pc_leaf(wqkv)
                and cfg.use_decode_attn_kernel):
            return _decode_step(dec_params, cfg, h, cache, offset)
        return _block_decode(dec_params, cfg, h, cache, offset, int(n_valid))
    T = h.shape[0]
    valid = torch.full((1,), n_valid, dtype=torch.int32, device=h.device)
    out = _prefill_layers(dec_params, cfg, h[None], valid,
                          lambda l, k, v: _store(cache, l, slice(0, T), k[0], v[0]))
    return out[0]


def decoder_prefill_batch(dec_params: dict, cfg: DecoderConfig,
                          h: torch.Tensor, kv_valid_len: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
    """Batched prefill: h [B, P, hidden] prompt embeddings (prompts
    left-aligned, positions 0 .. P-1 shared), kv_valid_len [B] int32 the
    real prompt lengths -> (hidden [B, P, hidden], rows {"k", "v"}: [L, B,
    P, n_kv, head_dim] fresh cache rows in h's dtype, which the caller
    quantizes into its cache)."""
    valid = torch.as_tensor(kv_valid_len, dtype=torch.int32,
                            device=h.device).reshape(-1)
    ks, vs = [], []
    h = _prefill_layers(dec_params, cfg, h, valid,
                        lambda l, k, v: (ks.append(k), vs.append(v)))
    return h, {"k": torch.stack(ks), "v": torch.stack(vs)}


def lm_logits(dec_params: dict, cfg: DecoderConfig, h_last: torch.Tensor) -> torch.Tensor:
    """Tied lm head on one row: [hidden] -> [vocab] f32."""
    return lm_logits_block(dec_params, cfg, h_last[None])[0]


def _dense_logits(x: torch.Tensor, embd: torch.Tensor) -> torch.Tensor:
    """x [T, hidden] @ token_embd.T with an f32 result, as the reference's
    dot with preferred_element_type=f32 (no f32 copy of the table on the
    card)."""
    if x.device.type == "cuda":
        return torch.mm(x, embd.t(), out_dtype=torch.float32)
    return x.float() @ embd.float().t()


def lm_logits_block(dec_params: dict, cfg: DecoderConfig,
                    h: torch.Tensor) -> torch.Tensor:
    """Tied lm head over a block of rows: [T, hidden] -> [T, vocab] f32,
    through the Q8_0 copy (K6, its zero-padded columns sliced off before
    any argmax), the int8pc copy, or the dense table."""
    if "lm_head_q8" in dec_params:
        return q8_norm_matmul(h, dec_params["lm_head_q8"], dec_params["output_norm"],
                              cfg.rms_norm_eps)[:, :cfg.vocab_size]
    x = rms_norm(h, dec_params["output_norm"], cfg.rms_norm_eps)
    if "lm_head_pc" in dec_params:
        return matmul_any(x.float(), dec_params["lm_head_pc"])
    return _dense_logits(x, dec_params["token_embd"])


def classify_logits(dec_params: dict, cfg: DecoderConfig,
                    h: torch.Tensor) -> torch.Tensor:
    """The aligner's classification head over every row: the final RMSNorm,
    then [T, hidden] @ classify_w with an f32 result, plus the bias in f32
    -> [T, classify_num] f32."""
    x = rms_norm(h, dec_params["output_norm"], cfg.rms_norm_eps)
    w = dec_params["classify_w"]
    if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
        logits = torch.mm(x, w, out_dtype=torch.float32)
    else:
        logits = x.float() @ w.float()
    if dec_params.get("classify_b") is not None:
        logits = logits + dec_params["classify_b"].float()
    return logits
