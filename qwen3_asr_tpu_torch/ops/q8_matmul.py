"""Quantized matmuls: Q8_0 weights (the kernels K5-K7 of
`csrc/q8_matmul.cu`, with their plain PyTorch twins) and the per-output-
channel W8A8 product of the int8pc mode.

Port of qwen3_asr_tpu/ops/q8_matmul.py.

Q8_0 leaves `{"q8:q", "q8:s"}` hold int8 weights [in, out] and f32 scales
[in/32, out] with W[i, o] = q[i, o] * s[i // 32, o] (GGUF Q8_0 after the
load-time transpose). `q8_matmul` (K5), `q8_norm_matmul` (K6, an f32 RMSNorm
prologue) and `q8_mlp` (K7, the whole SwiGLU MLP) compute what the Pallas
bodies compute, for T <= `_MAX_KERNEL_ROWS` rows: each wrapper takes the
twin for a CPU tensor and launches its kernel (counting the launch in
`.launches`) or raises for a CUDA tensor. Above that row count the JAX
package leaves the product to XLA (`_q8_matmul_xla`: dequantize, then one f32
dot); the port does the same with one f32 `torch.matmul`, TF32 off, on any
device, and counts no launch.

int8pc: weights int8 [in, out] with one f32 scale per output column;
activations quantize per row to int8 (absmax / 127, round half to even); the
int8 x int8 product accumulates in int32 and is rescaled by (sx * s). In the
JAX package this is XLA, not a Pallas kernel, so the port carries the product
with `torch._int_mm` on CUDA and with an exact float64 matmul of the int8
values on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qwen3_asr_tpu_torch.ops.support import (
    check,
    full_f32,
    raise_on_error,
    require_cuda,
    stream_ptr,
)

# XLA, and so the reference, divides by a constant as a product with its
# f32 reciprocal; the port does the same to keep int8pc scales bit-equal.
INV127 = float(np.float32(1.0 / 127.0))

Q8_BLOCK = 32
# Above this row count the reference dequantizes and runs one XLA dot.
_MAX_KERNEL_ROWS = 256


# ---------------------------------------------------------------------------
# Q8_0 weights
# ---------------------------------------------------------------------------

def quantize_q8_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float [in, out] -> (int8 [in, out], f32 scales [in/32, out]). The
    reference's numpy math in f32: s = amax / 127 (a true division, not
    the int8pc product with INV127), q = round(w * (1 / s)), half to even."""
    w = w.float()
    n_in, n_out = w.shape
    if n_in % Q8_BLOCK:
        raise ValueError(f"Q8_0 needs an in dim that is a multiple of 32, got {n_in}")
    blocks = w.reshape(n_in // Q8_BLOCK, Q8_BLOCK, n_out)
    s = blocks.abs().amax(dim=1) / 127.0
    inv = torch.where(s > 0, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(blocks * inv[:, None, :]), -127, 127)
    return q.to(torch.int8).reshape(n_in, n_out), s


def dequantize_q8_weights(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 [in, out], f32 [in/32, out] -> f32 [in, out]."""
    n_in, n_out = q.shape
    blocks = q.reshape(-1, Q8_BLOCK, n_out).float()
    return (blocks * s[:, None, :].float()).reshape(n_in, n_out)


def quant_leaf(w: torch.Tensor, pad_out_to: int = 1) -> dict:
    """A Q8_0 leaf from a float [in, out] matrix, its out dim zero-padded
    once to a multiple of `pad_out_to`. A padded leaf returns the padded
    columns; callers slice back to the true width (zero columns would
    otherwise win an argmax over negative logits)."""
    n_out = w.shape[1]
    padded = -(-n_out // pad_out_to) * pad_out_to
    if padded != n_out:
        w = torch.nn.functional.pad(w.float(), (0, padded - n_out))
    q, s = quantize_q8_weights(w)
    return {"q8:q": q.contiguous(), "q8:s": s.contiguous()}


def is_quant_leaf(w) -> bool:
    return isinstance(w, dict) and "q8:q" in w


def is_pc_leaf(w) -> bool:
    return isinstance(w, dict) and "i8pc:q" in w


def deq_bf16_for(n_out: int) -> bool:
    """The reference's dequant dtype for an output width (`_tile_for`): bf16
    from 2,048 columns, f32 below, judged at the width padded to a multiple
    of the 512-column tile, where the reference dispatches again."""
    if n_out < 2048 and n_out % min(512, n_out):
        n_out = -(-n_out // 512) * 512
    return n_out >= 2048


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _deq_tile(q: torch.Tensor, s: torch.Tensor, bf16: bool) -> torch.Tensor:
    """The kernels' dequantized weight in f32: q * s, or bf16(q * bf16(s))."""
    if bf16:
        return _bf(dequantize_q8_weights(q, _bf(s)))
    return dequantize_q8_weights(q, s)


def rms_norm_f32(x: torch.Tensor, nw: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernels' RMSNorm, all in f32: x * rsqrt(mean(x^2) + eps) * nw."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return y * nw.float()


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with full_f32():
        return x.float() @ w


def _q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The reference's XLA path: W = dequant(q, s) in x's dtype, then one
    f32 dot (rows above _MAX_KERNEL_ROWS)."""
    w = dequantize_q8_weights(q, s).to(x.dtype).float()
    return _matmul_f32(x, w)


def q8_matmul_ref(x, q, s) -> torch.Tensor:
    """Plain twin of K5: x [T, in] @ Q8_0 W -> f32 [T, out], dequantized at
    the reference's dtype for this width (x rounded to bf16 with it)."""
    bf16 = deq_bf16_for(q.shape[1])
    xk = _bf(x) if bf16 else x.float()
    return _matmul_f32(xk, _deq_tile(q, s, bf16))


def q8_norm_matmul_ref(x, q, s, norm_w, eps: float) -> torch.Tensor:
    """Plain twin of K6: the f32 RMSNorm * norm_w, then K5's product."""
    bf16 = deq_bf16_for(q.shape[1])
    xn = rms_norm_f32(x, norm_w, eps)
    return _matmul_f32(_bf(xn) if bf16 else xn, _deq_tile(q, s, bf16))


def q8_mlp_ref(x, qgu, sgu, qd, sd, norm_w, eps: float, n_ffn: int) -> torch.Tensor:
    """Plain twin of K7: xn = bf16(RMSNorm(x) * norm_w); g, u = xn @ the
    bf16-dequantized gate / up halves (f32 sums); ffn = bf16(silu(g) * u)
    in f32; ffn @ the bf16-dequantized down weight -> f32 [T, out]."""
    xn = _bf(rms_norm_f32(x, norm_w, eps))
    gu = _matmul_f32(xn, _deq_tile(qgu, sgu, True))
    g, u = gu[:, :n_ffn], gu[:, n_ffn:]
    ffn = _bf(g * torch.sigmoid(g) * u)
    return _matmul_f32(ffn, _deq_tile(qd, sd, True))


# -- the kernels ---------------------------------------------------------------

def check_kernel_args(T: int, n_in: int, n_out: int, n_ffn: int | None = None) -> None:
    """The shapes the kernel body takes, checked before a launch on any
    device (`args_ok` in `csrc/q8_matmul.cu`): 1 <= T <= _MAX_KERNEL_ROWS
    rows, an input width in 32-row Q8_0 blocks, and output columns in
    64-column tiles; with n_ffn (K7's gate-up product) the weight is the
    gate and up halves, [n_in, 2 n_ffn], in tiles of 32 gate and 32 up
    columns. Raises ValueError."""
    if not 1 <= T <= _MAX_KERNEL_ROWS:
        raise ValueError(f"q8 kernels take 1 to {_MAX_KERNEL_ROWS} rows, got {T}")
    if n_in <= 0 or n_in % Q8_BLOCK:
        raise ValueError(f"q8 kernels take an input width in {Q8_BLOCK}-row blocks, "
                         f"got {n_in}")
    if n_ffn is None:
        if n_out <= 0 or n_out % 64:
            raise ValueError(f"q8 kernels take output columns in 64-column tiles, "
                             f"got {n_out}")
    elif n_ffn <= 0 or n_ffn % 32 or n_out != 2 * n_ffn:
        raise ValueError(f"q8_mlp: the gate|up weight [{n_in}, {n_out}] is not two "
                         f"halves of {n_ffn} columns in 32-column tiles")


def _check_leaf(q, s, n_in: int, dev, name: str) -> None:
    n_out = q.shape[-1]
    check(q, f"{name} q", torch.int8, (n_in, n_out), dev)
    check(s, f"{name} s", torch.float32, (n_in // Q8_BLOCK, n_out), dev)


def _float_arg(t: torch.Tensor, name: str, shape, dev) -> int:
    """A bf16 or f32 input: -> 1 if bf16. Validates like `check`."""
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: expected bfloat16 or float32, got {t.dtype}")
    check(t, name, t.dtype, shape, dev)
    return int(t.dtype == torch.bfloat16)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it if its data does not start on 16 bytes (the
    kernel reads x and the norm weight in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_matmul(x, q, s, norm_w, eps: float) -> torch.Tensor:
    from qwen3_asr_tpu_torch.ops.build import kernel

    T, n_in = x.shape
    n_out = q.shape[1]
    dev = x.device
    x_bf16 = _float_arg(x, "x", (T, n_in), dev)
    _check_leaf(q, s, n_in, dev, "W")
    nw_bf16, nw_ptr = 0, None
    if norm_w is not None:
        nw_bf16 = _float_arg(norm_w, "norm_w", (n_in,), dev)
        nw_ptr = norm_w.data_ptr()
    check_kernel_args(T, n_in, n_out)
    out = torch.empty(T, n_out, dtype=torch.float32, device=dev)
    fn = kernel("qw_q8_matmul", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), x_bf16, nw_ptr, nw_bf16, float(eps), q.data_ptr(), s.data_ptr(),
            out.data_ptr(), T, n_in, n_out, int(deq_bf16_for(n_out)), stream_ptr(dev))
    raise_on_error(rc, "q8_norm_matmul" if norm_w is not None else "q8_matmul")
    return out


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """K5: x [T, in] (bf16 or f32) x Q8_0 W [in, out] -> f32 [T, out]. CPU
    tensors take the twin; CUDA tensors launch the kernel or raise."""
    if x.shape[0] > _MAX_KERNEL_ROWS:
        return _q8_matmul_plain(x, q, s)
    if x.device.type == "cpu":
        return q8_matmul_ref(x, q, s)
    require_cuda(x, "x")
    out = _launch_matmul(_aligned(x.contiguous()), q, s, None, 0.0)
    q8_matmul.launches += 1
    return out


q8_matmul.launches = 0


def q8_norm_matmul(x: torch.Tensor, leaf: dict, norm_w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """K6: rms_norm(x) * norm_w @ W with the norm fused, x [T, in] (any
    float dtype), leaf {q8:q [in, out], q8:s} -> f32 [T, out]."""
    q, s = leaf["q8:q"], leaf["q8:s"]
    if x.shape[0] > _MAX_KERNEL_ROWS:
        return _q8_matmul_plain(rms_norm_f32(x, norm_w, eps), q, s)
    if x.device.type == "cpu":
        return q8_norm_matmul_ref(x, q, s, norm_w, eps)
    require_cuda(x, "x")
    out = _launch_matmul(_aligned(x.contiguous()), q, s, _aligned(norm_w.contiguous()), eps)
    q8_norm_matmul.launches += 1
    return out


q8_norm_matmul.launches = 0


def q8_mlp(x: torch.Tensor, gu_leaf: dict, down_leaf: dict, norm_w: torch.Tensor,
           eps: float, n_ffn: int) -> torch.Tensor:
    """K7: the SwiGLU MLP on Q8_0 weights, rms_norm -> gate / up -> silu *
    mul -> down. gu_leaf is the fused [in, 2 n_ffn] gate|up weight,
    down_leaf [n_ffn, out]. -> f32 [T, out] (the caller adds the
    residual). One call is one count, though the kernel is two launches."""
    qgu, sgu = gu_leaf["q8:q"], gu_leaf["q8:s"]
    qd, sd = down_leaf["q8:q"], down_leaf["q8:s"]
    if x.shape[0] > _MAX_KERNEL_ROWS:
        gu = _q8_matmul_plain(rms_norm_f32(x, norm_w, eps), qgu, sgu)
        g = gu[:, :n_ffn]
        return _q8_matmul_plain(g * torch.sigmoid(g) * gu[:, n_ffn:], qd, sd)
    if x.device.type == "cpu":
        return q8_mlp_ref(x, qgu, sgu, qd, sd, norm_w, eps, n_ffn)
    require_cuda(x, "x")
    from qwen3_asr_tpu_torch.ops.build import kernel

    x, norm_w = _aligned(x.contiguous()), _aligned(norm_w.contiguous())
    T, n_in = x.shape
    n_out = qd.shape[1]
    dev = x.device
    x_bf16 = _float_arg(x, "x", (T, n_in), dev)
    nw_bf16 = _float_arg(norm_w, "norm_w", (n_in,), dev)
    _check_leaf(qgu, sgu, n_in, dev, "W_gate_up")
    _check_leaf(qd, sd, n_ffn, dev, "W_down")
    check_kernel_args(T, n_in, qgu.shape[1], n_ffn)
    check_kernel_args(T, n_ffn, n_out)
    ffn = torch.empty(T, n_ffn, dtype=torch.bfloat16, device=dev)
    out = torch.empty(T, n_out, dtype=torch.float32, device=dev)
    fn = kernel("qw_q8_mlp", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_float] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), x_bf16, norm_w.data_ptr(), nw_bf16, float(eps), qgu.data_ptr(),
            sgu.data_ptr(), qd.data_ptr(), sd.data_ptr(), ffn.data_ptr(), out.data_ptr(),
            T, n_in, n_ffn, n_out, stream_ptr(dev))
    raise_on_error(rc, "q8_mlp")
    q8_mlp.launches += 1
    return out


q8_mlp.launches = 0


def matmul_any(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w in x's dtype for a dense matrix, a Q8_0 leaf (K5) or an int8pc
    leaf."""
    if is_quant_leaf(w):
        return q8_matmul(x, w["q8:q"], w["q8:s"]).to(x.dtype)
    if is_pc_leaf(w):
        return pc_matmul(x, w["i8pc:q"], w["i8pc:s"]).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# per-output-channel W8A8 (int8pc)
# ---------------------------------------------------------------------------

def quantize_pc_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float [..., in, out] -> (int8 [..., in, out], f32 scale [..., out]).
    Same math as the reference's jitted pass (XLA turns its division by
    the constant 127 into a product with f32(1/127)): s = amax * (1/127),
    q = round(w * (1 / s))."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    s = amax * INV127
    inv = torch.where(s > 0, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(wf * inv.unsqueeze(-2)), -127, 127)
    return q.to(torch.int8), s


def pc_leaf(w: torch.Tensor) -> dict:
    """An int8pc leaf {i8pc:q, i8pc:s} from a float [in, out] matrix, by the
    reference's numpy quantizer: s = amax / 127 (a true division, where
    quantize_pc_weights mirrors the jitted pass's product with f32(1/127)),
    q = round(w * (1 / s))."""
    wf = w.float()
    s = wf.abs().amax(dim=0) / 127.0
    inv = torch.where(s > 0, 1.0 / torch.where(s == 0, torch.ones_like(s), s),
                      torch.zeros_like(s))
    q = torch.clamp(torch.round(wf * inv[None, :]), -127, 127).to(torch.int8)
    return {"i8pc:q": q, "i8pc:s": s}


def quantize_rows(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [T, n] -> (int8 [T, n], f32 [T, 1]): per-row activation quant."""
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) * INV127, min=1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def padded_rows(T: int) -> int:
    """The row count `torch._int_mm` takes for T rows: more than 16, a
    multiple of 8."""
    return max(32, -(-T // 8) * 8)


def int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int8 [T, in] x int8 [in, out] -> int32 [T, out]."""
    if xq.device.type == "cuda":
        # _int_mm takes more than 16 rows and k, n multiples of 8
        T = xq.shape[0]
        Tp = padded_rows(T)
        if Tp != T:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, Tp - T))
        return torch._int_mm(xq, q)[:T]
    # |x|, |q| <= 127: every partial sum is an integer far below 2**53
    return (xq.double() @ q.double()).to(torch.int32)


def pc_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [T, in] float x int8 W (per-channel scales [out]) -> [T, out] f32."""
    xq, sx = quantize_rows(x.float())
    acc = int8_matmul(xq, q)
    return acc.float() * (sx * s[None, :])
