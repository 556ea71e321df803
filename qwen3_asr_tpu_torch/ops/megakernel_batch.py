"""Batched greedy decode step (up to 16 sequences, each at its own
position) on the decode pack (int4 or int8 weights) with an int8 or a bf16
KV cache: the CUDA kernels `csrc/megakernel_batch.cu` and their plain
PyTorch version.

Port of qwen3_asr_tpu/ops/megakernel_batch.py (`mega_decode_step_batch`) in
its resident mode, on the port's own packs
(`ops/megakernel.py::pack_megakernel_params`, the packs the single-sequence
step reads). The JAX kernel's only resident mode is the int8 cache, because
B bf16 slabs would not fit a TPU core's VMEM; on the card a block stages one
chunk of one row's slab whatever B is, so the port adds the bf16 cache
(`mega_decode_step_batch_bf16`), whose rows are K1's bf16-cache step, where
the reference sends bf16 batches to its vmapped XLA step. The streamed-KV
mode and the VMEM sizing (`mega_batch_max_context`,
`mega_batch_stream_max_batch`) are TPU artifacts and are not ported: the
card's kernel takes any S.

Cache layout at the public functions: k/v `[B, L, S, n_kv * head_dim]`
int8 with scales `[B, L, S, n_kv]` f32, or bf16 with none, so slab b is a
single-sequence cache (the JAX package keeps its scales as `[B, L, n_kv,
S]`). A step writes row `pos[b]` of slab b in place and reads rows `<
pos[b]`. Rows are independent: row b equals the single-sequence step on
slab b alone.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.megakernel import (
    _check_pack,
    _dims,
    _Dims,
    _Ptrs,
    mega_decode_step_ref,
)
from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)

MAX_BATCH = 16   # rows per launch (two 8-row n-tiles of the products' MMA)


def mega_decode_step_batch_ref(pack, cfg: DecoderConfig, tokens_or_x, pos,
                               k, v, k_s, v_s):
    """Plain version of the kernels: the single-sequence plain step on each
    row's slab, on any device. `pos` is a host sequence of B ints. Writes
    row pos[b] of slab b in place. -> (tokens int32 [B], h f32 [B, H])."""
    toks, hs = [], []
    for b, p in enumerate(_host_pos(pos)):
        t, h = mega_decode_step_ref(pack, cfg, tokens_or_x[b:b + 1], int(p), k[b], v[b],
                                    None if k_s is None else k_s[b],
                                    None if v_s is None else v_s[b])
        toks.append(t)
        hs.append(h)
    return torch.cat(toks), torch.cat(hs)


def _host_pos(pos) -> np.ndarray:
    if isinstance(pos, torch.Tensor):
        if pos.device.type != "cpu":
            raise ValueError("pos must be a host sequence (the bounds are "
                             "checked on the host)")
        pos = pos.numpy()
    return np.asarray(pos, np.int64).reshape(-1)


class BatchDecodeStep:
    """The batched CUDA decode step bound to one pack and one cache pool of
    B slabs (int8 with scales k_s / v_s, or bf16 with none): validates the
    pack and the pool once, allocates the scratch once, then launches a step
    per call through `qw_mega_decode_step_batch_i8` or
    `qw_mega_decode_step_batch` (bf16). The batch size is checked before
    the device."""

    def __init__(self, pack, cfg: DecoderConfig, k, v, k_s=None, v_s=None):
        from qwen3_asr_tpu_torch.ops.build import kernel

        dev = k.device
        B, L, S, _ = k.shape
        if not 1 <= B <= MAX_BATCH:
            raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
        require_cuda(k, "k cache")
        _check_pack(pack, cfg, dev)
        DKV, NKV = cfg.n_kv_heads * cfg.head_dim, cfg.n_kv_heads
        if k.dtype not in _ENTRIES:
            raise TypeError(f"k cache: expected int8 or bf16, got {k.dtype}")
        check(k, "k cache", k.dtype, (B, cfg.n_layers, S, DKV), dev)
        check(v, "v cache", k.dtype, (B, cfg.n_layers, S, DKV), dev)
        if k.dtype == torch.int8:
            if k_s is None or v_s is None:
                raise ValueError("an int8 cache needs its scales")
            check(k_s, "k scales", torch.float32, (B, cfg.n_layers, S, NKV), dev)
            check(v_s, "v scales", torch.float32, (B, cfg.n_layers, S, NKV), dev)
        elif k_s is not None or v_s is not None:
            raise ValueError("a bf16 cache takes no scales")
        self.cfg, self.dev, self.B, self.S = cfg, dev, B, S
        self.pack, self.caches = pack, (k, v, k_s, v_s)   # the launches hold their pointers
        self.counter = _COUNTERS[k.dtype]
        self._fn = kernel(_ENTRIES[k.dtype],
                          [ctypes.POINTER(_Ptrs), ctypes.POINTER(_Dims),
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        nbytes = kernel("qw_mega_batch_scratch_bytes",
                        [ctypes.POINTER(_Dims), ctypes.c_int], ctypes.c_size_t)(
            ctypes.byref(_dims(pack, cfg, S, 1)), B)
        self.scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self.h = torch.empty(B, cfg.hidden_size, dtype=torch.float32, device=dev)
        p = {n: pack[n].data_ptr() for n in (
            "embd", "attn_norm", "ffn_norm", "q_norm", "k_norm", "out_norm",
            "qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
            "head_q", "head_s")}
        self.ptrs = _Ptrs(**p, k_cache=k.data_ptr(), v_cache=v.data_ptr(),
                          k_scale=None if k_s is None else k_s.data_ptr(),
                          v_scale=None if v_s is None else v_s.data_ptr(),
                          h_out=self.h.data_ptr(),
                          scratch=self.scratch.data_ptr())

    def __call__(self, tokens_or_x: torch.Tensor, pos: torch.Tensor,
                 out: torch.Tensor, bounds: tuple[int, int]) -> None:
        """One step of all B rows: reads the int32 [B] tokens (or bf16
        [B, H] rows) and the int32 [B] positions on the device, writes the
        next tokens into `out` (int32 [B] on the device), `self.h` and row
        pos[b] of each slab. `bounds` = (lo, hi) are the host's bounds of
        every pos[b]: 1 <= lo and hi < S are checked, and hi sizes the
        attention grid."""
        lo, hi = check_bounds(bounds, self.S)
        if tokens_or_x.dtype == torch.int32:
            check(tokens_or_x, "tokens", torch.int32, (self.B,), self.dev)
            self.ptrs.token_in, self.ptrs.x_in = tokens_or_x.data_ptr(), None
        else:
            check(tokens_or_x, "x", torch.bfloat16,
                  (self.B, self.cfg.hidden_size), self.dev)
            self.ptrs.token_in, self.ptrs.x_in = None, tokens_or_x.data_ptr()
        check(pos, "pos", torch.int32, (self.B,), self.dev)
        check(out, "tokens out", torch.int32, (self.B,), self.dev)
        self.ptrs.token_out = out.data_ptr()
        dims = _dims(self.pack, self.cfg, self.S, hi)
        rc = self._fn(ctypes.byref(self.ptrs), ctypes.byref(dims),
                      ctypes.c_void_p(pos.data_ptr()), self.B,
                      stream_ptr(self.dev))
        raise_on_error(rc, self.counter.__name__)
        self.counter.launches += 1


def check_bounds(bounds, S: int) -> tuple[int, int]:
    """The host's bounds (lo, hi) of a step's positions as ints: raises
    ValueError unless 1 <= lo <= hi < S."""
    lo, hi = (int(b) for b in bounds)
    if not 1 <= lo <= hi < S:
        raise ValueError(f"positions bounded by [{lo}, {hi}] are not inside [1, {S})")
    return lo, hi


def mega_decode_step_batch(pack, cfg: DecoderConfig, tokens_or_x, pos,
                           k, v, k_s, v_s):
    """One greedy decode step of B <= 16 sequences, on either pack, int8
    KV. `tokens_or_x` is int32 [B] tokens (their embedding rows are
    gathered on the device) or bf16 [B, H] embedded rows; `pos` a host
    sequence of B positions, each in [1, S). Writes row pos[b] of slab b in
    place. -> (next tokens int32 [B], h f32 [B, H], the hidden states before
    the final norm). CPU tensors take the plain version; CUDA tensors launch
    the kernels or raise."""
    return _step_once(pack, cfg, tokens_or_x, pos, k, v, k_s, v_s)


def mega_decode_step_batch_bf16(pack, cfg: DecoderConfig, tokens_or_x, pos, k, v):
    """mega_decode_step_batch over bf16 slabs [B, L, S, n_kv * head_dim]
    (no scales): row b equals K1's bf16-cache step on slab b."""
    return _step_once(pack, cfg, tokens_or_x, pos, k, v, None, None)


def _step_once(pack, cfg: DecoderConfig, tokens_or_x, pos, k, v, k_s, v_s):
    hp = _host_pos(pos)
    if len(hp) != k.shape[0]:
        raise ValueError(f"{len(hp)} positions for {k.shape[0]} slabs")
    if k.device.type == "cpu":
        if not ((hp >= 1) & (hp < k.shape[2])).all():
            raise ValueError(f"positions {hp.tolist()} outside [1, "
                             f"{k.shape[2]})")
        return mega_decode_step_batch_ref(pack, cfg, tokens_or_x, hp,
                                          k, v, k_s, v_s)
    step = BatchDecodeStep(pack, cfg, k, v, k_s, v_s)
    out = torch.empty(k.shape[0], dtype=torch.int32, device=k.device)
    pos_d = torch.from_numpy(hp.astype(np.int32)).to(k.device)
    step(tokens_or_x.to(k.device).contiguous(), pos_d, out,
         (int(hp.min()), int(hp.max())))
    return out, step.h


def _product_scratch_ints(B: int, K: int, N: int) -> int:
    from qwen3_asr_tpu_torch.ops.build import kernel

    return kernel("qw_mega_batch_product_scratch", [ctypes.c_int] * 3, ctypes.c_size_t)(B, K, N)


def product_scratch(B: int, K: int, N: int, device) -> torch.Tensor:
    """The zeroed int32 scratch of `batch_product_i8` at these sizes (the
    kernel leaves it zero, so one serves repeated calls)."""
    return torch.zeros(_product_scratch_ints(B, K, N), dtype=torch.int32, device=device)


def batch_product_i8(xq: torch.Tensor, w: torch.Tensor,
                     scratch: torch.Tensor | None = None) -> torch.Tensor:
    """One of the step's int8 products alone (`qw_mega_batch_product_i8`):
    int8 codes [B <= 16, K] x int8 weights [K, N] -> the exact int32 sums
    [B, N], on the tensor cores as the step runs them (for holding them
    against a library product). `scratch`: `product_scratch(B, K, N)`, or
    None to allocate one. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    B, K = xq.shape
    if w.shape[0] != K or xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"codes {tuple(xq.shape)} {xq.dtype} and weights "
                         f"{tuple(w.shape)} {w.dtype} do not make an int8 product")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
    if xq.device.type == "cpu":
        from qwen3_asr_tpu_torch.ops.q8_matmul import int8_matmul

        return int8_matmul(xq, w)
    from qwen3_asr_tpu_torch.ops.build import kernel

    N = w.shape[1]
    check(xq, "codes", torch.int8, (B, K), xq.device)
    check(w, "weights", torch.int8, (K, N), xq.device)
    out = torch.empty(B, N, dtype=torch.int32, device=xq.device)
    if scratch is None:
        scratch = product_scratch(B, K, N, xq.device)
    check(scratch, "scratch", torch.int32, (_product_scratch_ints(B, K, N),), xq.device)
    rc = kernel("qw_mega_batch_product_i8", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])(xq.data_ptr(), w.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), B, K, N, stream_ptr(xq.device))
    raise_on_error(rc, "batch_product_i8")
    batch_product_i8.launches += 1
    return out


mega_decode_step_batch.launches = 0
mega_decode_step_batch_bf16.launches = 0
batch_product_i8.launches = 0
# the wrapper whose count a step adds to, and its C entry, by cache dtype
_COUNTERS = {torch.int8: mega_decode_step_batch, torch.bfloat16: mega_decode_step_batch_bf16}
_ENTRIES = {torch.int8: "qw_mega_decode_step_batch_i8",
            torch.bfloat16: "qw_mega_decode_step_batch"}
