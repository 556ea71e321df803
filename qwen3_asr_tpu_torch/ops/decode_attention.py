"""Single-token decode attention: the CUDA kernels
`csrc/decode_attention.cu` (K4) and their plain PyTorch twin.

Port of qwen3_asr_tpu/ops/decode_attention.py (`decode_attention`, Pallas
bodies `_decode_attn_kernel` / `_decode_attn_kernel_q`), with its signature:

  in : qkv [1, (n_heads + 2 n_kv) * D], the attention projection's row laid
       out q_all | k_all | v_all; k_cache / v_cache [S, n_kv, D] (bf16, or
       int8 with k_scale / v_scale [S, n_kv] f32); offset (cache rows < offset
       are live); pos (the fresh token's RoPE position)
  out: attn [1, n_heads * D] f32, k_new / v_new [1, n_kv, D] f32 (normed and
       roped k, raw v) for the caller to store in the cache's format.

The fresh K/V takes part as one extra score column of the one softmax.
`offset` and `pos` are host ints: they size the kernel's grid.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qwen3_asr_tpu_torch.ops.q8_matmul import rms_norm_f32
from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)


def rope_coef(theta: float, D: int) -> float:
    """The f32 exponent step of the in-kernel RoPE frequencies:
    inv[k] = exp(k * rope_coef)."""
    return float(np.float32(-2.0 * float(np.log(theta)) / D))


def rope_row(x: torch.Tensor, pos: int, theta: float) -> torch.Tensor:
    """NEOX rotary on [rows, D] f32 at integer position pos, with the
    reference kernel's frequencies exp(k * (-2 log(theta) / D))."""
    D = x.shape[-1]
    half = D // 2
    k = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = torch.exp(k * rope_coef(theta, D))
    ang = float(pos) * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[:, :half], x[:, half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=1)


def decode_attention_ref(qkv, k_cache, v_cache, q_norm, k_norm, offset: int,
                         pos: int, *, n_heads: int, n_kv: int, head_dim: int,
                         eps: float, theta: float, scale: float,
                         k_scale=None, v_scale=None):
    """Plain twin of the kernel: the Pallas body's f32 math on the live
    rows < offset (the body's masked rows add exp(-0.7 max) = 0 exactly)."""
    D, group = head_dim, n_heads // n_kv
    rows = qkv.reshape(n_heads + 2 * n_kv, D).float()
    q_all = rope_row(rms_norm_f32(rows[:n_heads], q_norm, eps), pos, theta) * scale
    k_all = rope_row(rms_norm_f32(rows[n_heads:n_heads + n_kv], k_norm, eps), pos, theta)
    v_all = rows[n_heads + n_kv:]
    kc = k_cache[:offset].float()
    vc = v_cache[:offset].float()
    if k_scale is not None:
        kc = kc * k_scale[:offset, :, None].float()
        vc = vc * v_scale[:offset, :, None].float()
    heads = []
    for h in range(n_kv):
        q = q_all[h * group:(h + 1) * group]                     # [group, D]
        s_cache = q @ kc[:, h].T                                 # [group, offset]
        s_fresh = q @ k_all[h:h + 1].T                           # [group, 1]
        m = s_fresh
        if offset:
            m = torch.maximum(s_cache.amax(dim=1, keepdim=True), s_fresh)
        p_cache = torch.exp(s_cache - m)
        p_fresh = torch.exp(s_fresh - m)
        l = p_cache.sum(dim=1, keepdim=True) + p_fresh
        out = p_cache @ vc[:, h]
        heads.append((out + p_fresh * v_all[h:h + 1]) / l)
    attn = torch.cat(heads, dim=0).reshape(1, n_heads * D)
    return attn, k_all.reshape(1, n_kv, D), v_all.reshape(1, n_kv, D)


def _launch(qkv, k_cache, v_cache, q_norm, k_norm, offset, pos, n_heads, n_kv,
            D, eps, theta, scale, k_scale, v_scale):
    from qwen3_asr_tpu_torch.ops.build import kernel

    dev = qkv.device
    S = k_cache.shape[0]
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv: expected bfloat16 or float32, got {qkv.dtype}")
    check(qkv, "qkv", qkv.dtype, (1, (n_heads + 2 * n_kv) * D), dev)
    quant = k_scale is not None
    cdt = torch.int8 if quant else torch.bfloat16
    check(k_cache, "k_cache", cdt, (S, n_kv, D), dev)
    check(v_cache, "v_cache", cdt, (S, n_kv, D), dev)
    if quant:
        check(k_scale, "k_scale", torch.float32, (S, n_kv), dev)
        check(v_scale, "v_scale", torch.float32, (S, n_kv), dev)
    if q_norm.dtype != k_norm.dtype or q_norm.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("q_norm / k_norm: expected one dtype, bfloat16 or float32")
    check(q_norm, "q_norm", q_norm.dtype, (D,), dev)
    check(k_norm, "k_norm", k_norm.dtype, (D,), dev)
    if n_heads % n_kv or D % 16 or D > 256 or not 0 <= offset <= S:
        raise ValueError(f"decode_attention takes n_heads % n_kv == 0, D % 16 "
                         f"== 0, D <= 256, 0 <= offset <= S (got {n_heads}, "
                         f"{n_kv}, {D}, offset {offset}, S {S})")
    n_part = kernel("qw_decode_attention_scratch", [ctypes.c_int] * 4,
                    ctypes.c_size_t)(n_heads, n_kv, D, offset)
    part = torch.empty(max(int(n_part), 1), dtype=torch.float32, device=dev)
    attn = torch.empty(1, n_heads * D, dtype=torch.float32, device=dev)
    k_new = torch.empty(1, n_kv, D, dtype=torch.float32, device=dev)
    v_new = torch.empty(1, n_kv, D, dtype=torch.float32, device=dev)
    fn = kernel("qw_decode_attention",
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    rc = fn(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, q_norm.data_ptr(), k_norm.data_ptr(),
            int(q_norm.dtype == torch.bfloat16), part.data_ptr(), attn.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), S, int(offset), int(pos), n_heads,
            n_kv, D, float(eps), rope_coef(theta, D), float(np.float32(scale)),
            stream_ptr(dev))
    raise_on_error(rc, "decode_attention")
    return attn, k_new, v_new


def decode_attention(qkv, k_cache, v_cache, q_norm, k_norm, offset: int, pos: int,
                     *, n_heads: int, n_kv: int, head_dim: int, eps: float,
                     theta: float, scale: float, k_scale=None, v_scale=None):
    """-> (attn [1, n_heads * D] f32, k_new [1, n_kv, D] f32, v_new [1, n_kv,
    D] f32). CPU tensors take the twin; CUDA tensors launch the kernel or
    raise."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              theta=theta, scale=scale, k_scale=k_scale, v_scale=v_scale)
    if k_cache.device.type == "cpu":
        return decode_attention_ref(qkv, k_cache, v_cache, q_norm, k_norm,
                                    int(offset), int(pos), **kw)
    require_cuda(k_cache, "k_cache")
    out = _launch(qkv.contiguous(), k_cache, v_cache, q_norm.contiguous(),
                  k_norm.contiguous(), int(offset), int(pos), n_heads, n_kv,
                  head_dim, eps, theta, scale, k_scale, v_scale)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
