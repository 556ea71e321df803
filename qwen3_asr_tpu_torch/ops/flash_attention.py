"""Flash attention: the CUDA kernel `csrc/flash_attention.cu` (bf16 tensor-core
products, mma.sync) and its plain PyTorch twin.

Port of qwen3_asr_tpu/ops/pallas_attention.py (`_flash_kernel`,
`flash_attention_batch`, `flash_attention`). Layouts are the JAX package's:
q [B, T, n_heads, D], k/v [B, S, n_kv, D]. The head dim is used as it is
(64 or 128 in the kernel); nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)

NEG = -0.7 * float(torch.finfo(torch.float32).max)  # NaN-safe mask value


def flash_attention_ref(q, k, v, valid_lens, *, causal: bool, scale: float):
    """Plain twin of the kernel: the same masked softmax in f32, in one pass
    instead of streamed tiles (equal up to f32 summation order)."""
    B, T, NH, D = q.shape
    _, S, NKV, _ = k.shape
    group = NH // NKV
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bthd,bshd->bhts", qf, kf)
    col = torch.arange(S, device=q.device)
    valid = valid_lens.to(q.device).reshape(B, 1, 1, 1)
    mask = col[None, None, None, :] < valid
    if causal:
        row = torch.arange(T, device=q.device)
        mask = mask & (col[None, :] <= row[:, None])[None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    out = out / torch.clamp(l, min=1e-30).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def check_kernel_args(q, k, v, valid) -> None:
    """What the kernel takes, checked before a launch on any device: bf16
    contiguous q [B, T, NH, D] and k, v [B, S, NKV, D] on q's device, int32
    valid [B], D 64 or 128, NH a multiple of NKV (GQA). Raises TypeError or
    ValueError."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash kernel takes q [B, T, NH, D] and k, v [B, S, NKV, D] "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)})")
    B, T, NH, D = q.shape
    _, S, NKV, _ = k.shape
    dev = q.device
    check(q, "q", torch.bfloat16, device=dev)
    check(k, "k", torch.bfloat16, (B, S, NKV, D), dev)
    check(v, "v", torch.bfloat16, (B, S, NKV, D), dev)
    check(valid, "valid_lens", torch.int32, (B,), dev)
    if D not in (64, 128) or NH % NKV:
        raise ValueError(f"flash kernel takes D in (64, 128) and NH % NKV == 0"
                         f" (got D={D}, NH={NH}, NKV={NKV})")


def _launch(q, k, v, valid, causal: bool, scale: float) -> torch.Tensor:
    from qwen3_asr_tpu_torch.ops.build import kernel

    check_kernel_args(q, k, v, valid)
    B, T, NH, D = q.shape
    _, S, NKV, _ = k.shape
    dev = q.device
    out = torch.empty_like(q)
    fn = kernel("qw_flash_attention", [ctypes.c_void_p] * 5
                + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, T, S, NH, NKV, D, int(causal), float(scale),
            stream_ptr(dev))
    raise_on_error(rc, "flash_attention")
    flash_attention_batch.launches += 1
    return out


def flash_attention_batch(q, k, v, valid_lens, *, causal: bool,
                          scale: float) -> torch.Tensor:
    """q [B, T, NH, D], k/v [B, S, NKV, D], valid_lens [B] int32 (keys at
    index >= valid_lens[b] are masked) -> [B, T, NH, D]. CPU tensors take
    the twin; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, valid_lens, causal=causal,
                                   scale=scale)
    require_cuda(q, "q")
    valid = torch.as_tensor(valid_lens, dtype=torch.int32,
                            device=q.device).reshape(-1)
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(), valid,
                   causal, scale)


flash_attention_batch.launches = 0


def flash_attention(q, k, v, valid_len, *, causal: bool,
                    scale: float) -> torch.Tensor:
    """Single item: q [T, NH, D], k/v [S, NKV, D], valid_len a scalar."""
    valid = torch.as_tensor(valid_len, dtype=torch.int32,
                            device=q.device).reshape(1)
    return flash_attention_batch(q[None], k[None], v[None], valid,
                                 causal=causal, scale=scale)[0]
