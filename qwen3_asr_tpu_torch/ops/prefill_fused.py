"""The int8pc prefill's fused passes: the four CUDA kernels of
`csrc/prefill_fused.cu` around the int8 products of
`models/decoder.py::_prefill_layers`, with their plain PyTorch twins.

They replace no TPU kernel: the JAX package leaves these ops to XLA, which
fuses them around its int8 dots. A layer on int8pc leaves runs, on the
flattened B * P prompt rows:

  norm_quant_rows        (layer 0) RMSNorm, then the rows' int8 codes
  int8_matmul            QKV
  qkv_epilogue           dequantize; q / k RMSNorm per head, NEOX RoPE
  flash_attention_batch  K2
  norm_quant_rows        the attention output's codes (no norm)
  int8_matmul            Wo
  residual_norm_quant    h1 = x + Wo's output; the codes of RMSNorm(h1)
  int8_matmul            gate-up
  swiglu_quant           silu(g) * u; its codes
  int8_matmul            down
  residual_norm_quant    x = h1 + down's output; the codes of the next
                         layer's RMSNorm(x) (none after the last layer)

Codes go into zeroed int8 buffers of `padded_rows(N)` rows
(`codes_buffer`), the row count `torch._int_mm` takes, which the product
reads as they lie; row scales sx are f32 [N, 1]. The twins are the eager
chain's own ops (`models/decoder.py`'s `rms_norm`, `rope_tables`,
`apply_rope` and `silu`, `ops/q8_matmul.py::quantize_rows`) in its order,
with the RoPE frequencies the caller passes (`models/decoder.py::
rope_inv_freq`, on the device once), so a CPU prefill is the
eager chain's bit for bit; the kernels differ from them only in the order
of each norm's f32 sum of squares. CPU tensors take the twin; CUDA tensors
launch the kernel (counted in `.launches`) or raise.
"""

from __future__ import annotations

import ctypes

import torch

from qwen3_asr_tpu_torch.ops.q8_matmul import INV127, _aligned, padded_rows, quantize_rows
from qwen3_asr_tpu_torch.ops.support import check, raise_on_error, require_cuda, stream_ptr

BF16, F32, I32, I8 = torch.bfloat16, torch.float32, torch.int32, torch.int8
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def codes_buffer(N: int, n: int, device) -> torch.Tensor:
    """A zeroed int8 [padded_rows(N), n] buffer for a product's input codes;
    rows >= N stay zero."""
    return torch.zeros(padded_rows(N), n, dtype=I8, device=device)


def _deq(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The int8pc product in bf16, as `pc_matmul(...).to(bfloat16)`."""
    return (acc[:sx.shape[0]].float() * (sx * s[None, :])).to(BF16)


def _put_codes(y: torch.Tensor, codes: torch.Tensor, sx: torch.Tensor) -> None:
    xq, s = quantize_rows(y.float())
    codes[:y.shape[0]] = xq
    sx.copy_(s)


# -- the twins -----------------------------------------------------------------

def norm_quant_rows_ref(x, w, eps: float, codes, sx) -> None:
    """Plain twin of `norm_quant_rows`."""
    from qwen3_asr_tpu_torch.models.decoder import rms_norm

    _put_codes(x if w is None else rms_norm(x, w, eps), codes, sx)


def qkv_epilogue_ref(acc, sx, s, q_norm, k_norm, P: int, n_heads: int, n_kv: int,
                     head_dim: int, eps: float, inv_freq):
    """Plain twin of `qkv_epilogue`."""
    from qwen3_asr_tpu_torch.models.decoder import apply_rope, rms_norm, rope_tables

    dq, dkv = n_heads * head_dim, n_kv * head_dim
    qkv = _deq(acc, sx, s).reshape(-1, P, dq + 2 * dkv)
    B = qkv.shape[0]
    q = qkv[..., :dq].reshape(B, P, n_heads, head_dim)
    k = qkv[..., dq:dq + dkv].reshape(B, P, n_kv, head_dim)
    v = qkv[..., dq + dkv:].reshape(B, P, n_kv, head_dim)
    positions = torch.arange(P, device=acc.device, dtype=I32)
    cos, sin = rope_tables(positions, inv_freq)
    q = apply_rope(rms_norm(q, q_norm, eps), cos, sin)
    k = apply_rope(rms_norm(k, k_norm, eps), cos, sin)
    return q, k, v


def residual_norm_quant_ref(res, acc, sx, s, w, eps: float, codes, sx_out):
    """Plain twin of `residual_norm_quant`."""
    h = res + _deq(acc, sx, s)
    if w is not None:
        norm_quant_rows_ref(h, w, eps, codes, sx_out)
    return h


def swiglu_quant_ref(acc, sx, s, n_ffn: int, codes, sx_out) -> None:
    """Plain twin of `swiglu_quant`."""
    from qwen3_asr_tpu_torch.models.decoder import silu

    g_u = _deq(acc, sx, s)
    _put_codes(silu(g_u[:, :n_ffn]) * g_u[:, n_ffn:], codes, sx_out)


# -- the kernels ---------------------------------------------------------------

def _check_codes(codes, sx, N: int, n: int, dev) -> None:
    check(codes, "codes", I8, (padded_rows(N), n), dev)
    check(sx, "sx", F32, (N, 1), dev)


def _check_acc(acc, N: int, n: int, dev) -> None:
    check(acc, "acc", I32, device=dev)
    if acc.dim() != 2 or acc.shape[0] < N or acc.shape[1] != n:
        raise ValueError(f"acc: expected int32 [>= {N}, {n}], got {tuple(acc.shape)}")


def norm_quant_rows(x: torch.Tensor, w: torch.Tensor | None, eps: float,
                    codes: torch.Tensor, sx: torch.Tensor) -> None:
    """x [N, n] bf16 -> codes[:N] (int8, a `codes_buffer`) and sx [N, 1] f32:
    the int8 codes and row scales of rms_norm(x, w) (w [n] bf16), or of x
    when w is None. In place."""
    if x.device.type == "cpu":
        return norm_quant_rows_ref(x, w, eps, codes, sx)
    require_cuda(x, "x")
    from qwen3_asr_tpu_torch.ops.build import kernel

    x = _aligned(x.contiguous())
    N, n = x.shape
    dev = x.device
    check(x, "x", BF16, device=dev)
    if w is not None:
        w = _aligned(w.contiguous())
        check(w, "w", BF16, (n,), dev)
    _check_codes(codes, sx, N, n, dev)
    fn = kernel("qw_pf_norm_quant", [_PTR, _PTR, _FLOAT, _FLOAT, _PTR, _PTR, _INT, _INT, _PTR])
    rc = fn(x.data_ptr(), None if w is None else w.data_ptr(), float(eps), INV127,
            codes.data_ptr(), sx.data_ptr(), N, n, stream_ptr(dev))
    raise_on_error(rc, "norm_quant_rows")
    norm_quant_rows.launches += 1


norm_quant_rows.launches = 0


def qkv_epilogue(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor,
                 q_norm: torch.Tensor, k_norm: torch.Tensor, P: int, n_heads: int,
                 n_kv: int, head_dim: int, eps: float, inv_freq: torch.Tensor):
    """The QKV product acc int32 [>= N, (n_heads + 2 n_kv) * head_dim] (row
    scales sx [N, 1], column scales s f32) of N = B * P prompt rows at
    positions 0 .. P - 1 -> q [B, P, n_heads, D], k, v [B, P, n_kv, D] bf16:
    q and k RMSNormed per head with q_norm / k_norm, then NEOX-roped at
    their positions with the frequencies inv_freq f32 [D / 2]; v as the
    product gives it."""
    if acc.device.type == "cpu":
        return qkv_epilogue_ref(acc, sx, s, q_norm, k_norm, P, n_heads, n_kv, head_dim,
                                eps, inv_freq)
    require_cuda(acc, "acc")
    from qwen3_asr_tpu_torch.ops.build import kernel

    N, D, dev = sx.shape[0], head_dim, acc.device
    cols = (n_heads + 2 * n_kv) * D
    _check_acc(acc, N, cols, dev)
    check(sx, "sx", F32, (N, 1), dev)
    check(s, "s", F32, (cols,), dev)
    check(q_norm, "q_norm", BF16, (D,), dev)
    check(k_norm, "k_norm", BF16, (D,), dev)
    check(inv_freq, "inv_freq", F32, (D // 2,), dev)
    if N % P:
        raise ValueError(f"qkv_epilogue: {N} rows are not whole prompts of {P}")
    B = N // P
    q = torch.empty(B, P, n_heads, D, dtype=BF16, device=dev)
    k = torch.empty(B, P, n_kv, D, dtype=BF16, device=dev)
    v = torch.empty_like(k)
    fn = kernel("qw_pf_qkv_epilogue", [_PTR] * 9 + [_INT] * 5 + [_FLOAT, _PTR])
    rc = fn(acc.data_ptr(), sx.data_ptr(), s.data_ptr(), q_norm.data_ptr(),
            k_norm.data_ptr(), inv_freq.data_ptr(),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), N, P, n_heads, n_kv, D, float(eps),
            stream_ptr(dev))
    raise_on_error(rc, "qkv_epilogue")
    qkv_epilogue.launches += 1
    return q, k, v


qkv_epilogue.launches = 0


def residual_norm_quant(res: torch.Tensor, acc: torch.Tensor, sx: torch.Tensor,
                        s: torch.Tensor, w: torch.Tensor | None, eps: float,
                        codes: torch.Tensor, sx_out: torch.Tensor) -> torch.Tensor:
    """res [N, n] bf16 + the product acc int32 [>= N, n] (row scales sx [N,
    1], column scales s [n]) in bf16 -> h [N, n] bf16; with w [n], also the
    codes and row scales of rms_norm(h, w) into codes[:N] / sx_out, in
    place."""
    if res.device.type == "cpu":
        return residual_norm_quant_ref(res, acc, sx, s, w, eps, codes, sx_out)
    require_cuda(res, "res")
    from qwen3_asr_tpu_torch.ops.build import kernel

    res, s = _aligned(res.contiguous()), _aligned(s.contiguous())
    N, n = res.shape
    dev = res.device
    check(res, "res", BF16, device=dev)
    _check_acc(acc, N, n, dev)
    check(sx, "sx", F32, (N, 1), dev)
    check(s, "s", F32, (n,), dev)
    if w is not None:
        w = _aligned(w.contiguous())
        check(w, "w", BF16, (n,), dev)
        _check_codes(codes, sx_out, N, n, dev)
    out = torch.empty_like(res)
    fn = kernel("qw_pf_residual_norm_quant",
                [_PTR] * 5 + [_FLOAT, _FLOAT] + [_PTR] * 3 + [_INT, _INT, _PTR])
    rc = fn(res.data_ptr(), acc.data_ptr(), sx.data_ptr(), s.data_ptr(),
            None if w is None else w.data_ptr(), float(eps), INV127, out.data_ptr(),
            codes.data_ptr(), sx_out.data_ptr(), N, n, stream_ptr(dev))
    raise_on_error(rc, "residual_norm_quant")
    residual_norm_quant.launches += 1
    return out


residual_norm_quant.launches = 0


def swiglu_quant(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor, n_ffn: int,
                 codes: torch.Tensor, sx_out: torch.Tensor) -> None:
    """The gate-up product acc int32 [>= N, 2 n_ffn] (row scales sx [N, 1],
    column scales s) in bf16, g | u -> the codes and row scales of bf16
    silu(g) * u (`models/decoder.py::silu`) into codes[:N] / sx_out, in
    place."""
    if acc.device.type == "cpu":
        return swiglu_quant_ref(acc, sx, s, n_ffn, codes, sx_out)
    require_cuda(acc, "acc")
    from qwen3_asr_tpu_torch.ops.build import kernel

    N, dev, s = sx.shape[0], acc.device, _aligned(s.contiguous())
    _check_acc(acc, N, 2 * n_ffn, dev)
    check(sx, "sx", F32, (N, 1), dev)
    check(s, "s", F32, (2 * n_ffn,), dev)
    _check_codes(codes, sx_out, N, n_ffn, dev)
    fn = kernel("qw_pf_swiglu_quant", [_PTR] * 3 + [_FLOAT, _PTR, _PTR, _INT, _INT, _PTR])
    rc = fn(acc.data_ptr(), sx.data_ptr(), s.data_ptr(), INV127, codes.data_ptr(),
            sx_out.data_ptr(), N, n_ffn, stream_ptr(dev))
    raise_on_error(rc, "swiglu_quant")
    swiglu_quant.launches += 1


swiglu_quant.launches = 0
