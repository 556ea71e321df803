"""Qwen3 text decoder: the prompt prefill and the single-token decode step.

Port of qwen3_asr_tpu/models/decoder.py: `rms_norm`, `rope_neox`,
`init_kv_cache` (bf16 rows, or int8 rows + per-(row, head) f32 scales),
`_quantize_kv_rows`, `embed_with_audio`, `decoder_forward` (the prefill, and
the decode step at T = 1 through the decode-attention kernel),
`decoder_prefill_batch`, and `lm_logits` / `lm_logits_block`.

The layers take the fused weight layout (`wqkv`, `w_gate_up`) with dense
bf16 matrices, Q8_0 leaves or int8pc leaves:
- Q8_0: QKV through `q8_norm_matmul` (K6), Wo through `q8_matmul` (K5) and
  the MLP through `q8_mlp` (K7), as the reference runs them on the TPU;
  above 256 rows those wrappers run the reference's dequantize-and-dot;
- dense: RMSNorm then plain matrix products, as the reference leaves them
  to XLA;
- int8pc: the W8A8 products of `pc_matmul` (prefill only: the int4 pack's
  decode steps run through `ops/megakernel.py`).
Attention in the prefill is the flash kernel (`ops/flash_attention.py`),
causal with the prompt's valid length; in the decode step it is
`ops/decode_attention.py` (K4).

Cache layout at the public functions is the JAX package's: k/v [L, S, n_kv,
head_dim] bf16 or int8, and for int8 k_s/v_s [L, S, n_kv] f32.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
from qwen3_asr_tpu_torch.ops.q8_matmul import (
    INV127,
    is_pc_leaf,
    is_quant_leaf,
    matmul_any,
    q8_mlp,
    q8_norm_matmul,
)


def rms_norm(x: torch.Tensor, w: torch.Tensor | None, eps: float) -> torch.Tensor:
    xf = x.float()
    y = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)).to(x.dtype)
    return y if w is None else y * w


def rope_neox(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """NEOX rotary embedding on [T, n_heads, head_dim]: pairs (x[i], x[i+d/2])."""
    d = x.shape[-1]
    half = d // 2
    inv_freq = torch.from_numpy(
        (1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2.0 / d)))
        .astype(np.float32)).to(x.device)
    ang = positions.float()[:, None] * inv_freq[None, :]
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


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


def _quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, n_kv, hd] float -> (int8 rows, f32 scales [T, n_kv])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV127, min=1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _store(cache: dict, l: int, rows, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write K/V rows ([n, n_kv, hd] for a slice of rows, [n_kv, hd] for one
    row index) into layer l's cache rows `rows`, in the cache's format."""
    for name, x in (("k", k), ("v", v)):
        if "k_s" in cache:
            q, s = _quantize_kv_rows(x)
            cache[name][l, rows] = q
            cache[name + "_s"][l, rows] = s
        else:
            cache[name][l, rows] = x.to(cache[name].dtype)


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
    eps = cfg.rms_norm_eps
    gu, down = _leaf(layers, "w_gate_up", l), _leaf(layers, "w_down", l)
    if is_quant_leaf(gu) and is_quant_leaf(down):   # the whole MLP in K7
        return h1 + q8_mlp(h1, gu, down, layers["ffn_norm"][l], eps,
                           cfg.intermediate_size).to(h1.dtype)
    g_u = matmul_any(rms_norm(h1, layers["ffn_norm"][l], eps), gu)
    ffn = g_u.shape[-1] // 2
    return h1 + matmul_any(silu(g_u[:, :ffn]) * g_u[:, ffn:], down)


def _prefill_layers(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    valid: torch.Tensor, on_rows) -> torch.Tensor:
    """The prefill's layer stack on prompt blocks h [B, P, hidden]: every
    matmul runs once on the flattened [B * P] rows, attention is the flash
    kernel, causal, keys at index >= valid[b] masked. Calls on_rows(l, k, v)
    with each layer's fresh rows [B, P, n_kv, head_dim] in h's dtype;
    returns the hidden states [B, P, hidden]."""
    B, P, H = h.shape
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv = NH * D, NKV * D
    scale = 1.0 / float(np.sqrt(D))
    positions = torch.arange(P, device=h.device, dtype=torch.int32)
    eps = cfg.rms_norm_eps
    layers = dec_params["layers"]
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


def _decode_step(dec_params: dict, cfg: DecoderConfig, x: torch.Tensor,
                 cache: dict, pos: int) -> torch.Tensor:
    """One token x [1, hidden] at position pos through every layer, in the
    reference's order: QKV, the decode-attention kernel over cache rows <
    pos plus the fresh column, bf16, Wo, the residual, the MLP, the
    residual; the fresh K/V row is stored at cache row pos. -> [1, hidden]."""
    layers = dec_params["layers"]
    if not cfg.use_decode_attn_kernel:
        raise NotImplementedError("use_decode_attn_kernel=False (the XLA "
                                  "decode attention) is not ported")
    if "wqkv" not in layers or is_pc_leaf(layers["wqkv"]):
        raise NotImplementedError("the decode step takes the fused dense or "
                                  "Q8_0 layout; int8pc decode steps run through "
                                  "ops/megakernel.py on the int4 pack")
    eps = cfg.rms_norm_eps
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    quant = "k_s" in cache
    for l in range(cfg.n_layers):
        qkv = _qkv(layers, l, x, eps)
        attn, k_new, v_new = decode_attention(
            qkv, cache["k"][l], cache["v"][l], layers["q_norm"][l],
            layers["k_norm"][l], pos, pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim, eps=eps,
            theta=cfg.rope_theta, scale=scale,
            k_scale=cache["k_s"][l] if quant else None,
            v_scale=cache["v_s"][l] if quant else None)
        h1 = x + matmul_any(attn.to(x.dtype), _leaf(layers, "wo", l))
        x = _mlp(layers, l, h1, cfg)
        _store(cache, l, pos, k_new[0], v_new[0])
    return x


def decoder_forward(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    cache: dict, n_valid: int, prefill: bool = True,
                    cache_offset: int = 0) -> torch.Tensor:
    """Run all layers and write this block's K/V rows into the cache in
    place. Returns the hidden states [T, hidden].

    prefill=True: h [T, hidden] is the prompt block (rows >= n_valid are
    padding) at positions 0 .. T-1; its rows go to cache rows [0, T).
    prefill=False: one decode step, h [1, hidden] at position cache_offset,
    attending to cache rows < cache_offset plus itself, its row written at
    cache_offset; n_valid is the reference's kv_valid_len = cache_offset + 1.
    """
    if not prefill:
        if h.shape[0] != 1 or n_valid != cache_offset + 1:
            raise ValueError("a decode step takes one row with kv_valid_len "
                             "= cache_offset + 1")
        return _decode_step(dec_params, cfg, h, cache, int(cache_offset))
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
