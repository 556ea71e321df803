"""Qwen3 text decoder: prompt prefill on the fused int8pc layout.

Port of qwen3_asr_tpu/models/decoder.py: `rms_norm`, `rope_neox`,
`init_kv_cache` (int8 rows + per-(row, head) f32 scales), `_quantize_kv_rows`,
`embed_with_audio`, `decoder_forward(prefill=True)`,
`decoder_prefill_batch`, and `lm_logits` / `lm_logits_block` (the
`lm_head_pc` branch). Attention in the prefill is the flash kernel
(`ops/flash_attention.py`), causal with the prompt's valid length. The
decode branch of `decoder_forward` is not ported: decode steps run through
the megakernel (`ops/megakernel.py`).

Cache layout at the public functions is the JAX package's: k/v
[L, S, n_kv, head_dim] int8, k_s/v_s [L, S, n_kv] f32.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
from qwen3_asr_tpu_torch.ops.q8_matmul import INV127, pc_matmul


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


def _pc(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x @ an int8pc leaf {"i8pc:q", "i8pc:s"}, in x's dtype."""
    return pc_matmul(x, w["i8pc:q"], w["i8pc:s"]).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))) with every op in x's dtype: in bf16 this
    rounds after each op, as jax.nn.silu does (F.silu rounds once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_kv_cache(cfg: DecoderConfig, n_ctx: int, device) -> dict:
    """Zeroed int8 cache [L, n_ctx, n_kv, head_dim] with per-(row, head) f32
    scales [L, n_ctx, n_kv]."""
    shape = (cfg.n_layers, n_ctx, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        "v_s": torch.zeros(shape[:3], dtype=torch.float32, device=device),
    }


def _quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, n_kv, hd] float -> (int8 rows, f32 scales [T, n_kv])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV127, min=1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


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


def _prefill_layers(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    valid: torch.Tensor, on_rows) -> torch.Tensor:
    """The prefill's layer stack on prompt blocks h [B, P, hidden]: every
    matmul runs once on the flattened [B * P] rows, attention is the flash
    kernel, causal, keys at index >= valid[b] masked. Calls on_rows(l, k, v)
    with each layer's fresh rows [B, P, n_kv, head_dim] in h's dtype;
    returns the hidden states [B, P, hidden]."""
    B, P, _ = h.shape
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dq, dkv = NH * D, NKV * D
    scale = 1.0 / float(np.sqrt(D))
    positions = torch.arange(P, device=h.device, dtype=torch.int32)
    eps = cfg.rms_norm_eps
    layers = dec_params["layers"]

    def leaf(key, l):
        return {k: v[l] for k, v in layers[key].items()}

    def flat(x, key, l):
        """x [B, P, in] @ an int8pc leaf, on the flattened rows."""
        return _pc(x.reshape(B * P, x.shape[-1]), leaf(key, l)).reshape(B, P, -1)

    for l in range(cfg.n_layers):
        x = rms_norm(h, layers["attn_norm"][l], eps)
        qkv = flat(x, "wqkv", l)
        q = qkv[..., :dq].reshape(B, P, NH, D)
        k = qkv[..., dq:dq + dkv].reshape(B, P, NKV, D)
        v = qkv[..., dq + dkv:].reshape(B, P, NKV, D)
        q = rope_neox(rms_norm(q, layers["q_norm"][l], eps), positions, cfg.rope_theta)
        k = rope_neox(rms_norm(k, layers["k_norm"][l], eps), positions, cfg.rope_theta)
        attn = flash_attention_batch(q, k, v, valid, causal=True, scale=scale)
        h1 = h + flat(attn.reshape(B, P, dq), "wo", l)
        gu = flat(rms_norm(h1, layers["ffn_norm"][l], eps), "w_gate_up", l)
        ffn = gu.shape[-1] // 2
        h = h1 + flat(silu(gu[..., :ffn]) * gu[..., ffn:], "w_down", l)
        on_rows(l, k, v)
    return h


def decoder_forward(dec_params: dict, cfg: DecoderConfig, h: torch.Tensor,
                    cache: dict, n_valid: int, prefill: bool = True
                    ) -> torch.Tensor:
    """`decoder_forward(prefill=True)` on the fused int8pc layout: run all
    layers over the prompt block h [T, hidden] (rows >= n_valid are padding)
    and write its int8 K/V rows into cache rows [0, T) in place. Returns the
    hidden states [T, hidden]."""
    if not prefill:
        raise NotImplementedError("decode steps run through "
                                  "ops/megakernel.py::mega_decode_step_i8")
    T = h.shape[0]
    valid = torch.full((1,), n_valid, dtype=torch.int32, device=h.device)

    def write(l, k, v):
        for name, rows in (("k", k[0]), ("v", v[0])):
            q8, s = _quantize_kv_rows(rows)
            cache[name][l, :T] = q8
            cache[name + "_s"][l, :T] = s

    return _prefill_layers(dec_params, cfg, h[None], valid, write)[0]


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
    """Tied lm head on one row through the int8pc copy: [hidden] -> [vocab] f32."""
    return lm_logits_block(dec_params, cfg, h_last[None])[0]


def lm_logits_block(dec_params: dict, cfg: DecoderConfig,
                    h: torch.Tensor) -> torch.Tensor:
    """Tied lm head over a block of rows through the int8pc copy: [T,
    hidden] -> [T, vocab] f32."""
    x = rms_norm(h, dec_params["output_norm"], cfg.rms_norm_eps)
    return _pc(x.float(), dec_params["lm_head_pc"])
