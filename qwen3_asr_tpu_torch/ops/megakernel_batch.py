"""Batched greedy decode step (up to 16 sequences, each at its own
position) with int4 weights and an int8 KV cache: the CUDA kernels
`csrc/megakernel_batch.cu` and their plain PyTorch version.

Port of qwen3_asr_tpu/ops/megakernel_batch.py (`mega_decode_step_batch`) in
its int4-weight / resident mode, on the port's own int4 pack
(`ops/megakernel.py::pack_megakernel_params`, the same pack the
single-sequence step reads). The streamed-KV mode and the VMEM sizing
(`mega_batch_max_context`, `mega_batch_stream_max_batch`) are TPU
artifacts and are not ported: the card's kernel takes any S.

Cache layout at the public functions: k/v `[B, L, S, n_kv * head_dim]`
int8 and scales `[B, L, S, n_kv]` f32, so slab b is a single-sequence cache
(the JAX package keeps its scales as `[B, L, n_kv, S]`). A step writes row
`pos[b]` of slab b in place and reads rows `< pos[b]`. Rows are
independent: row b equals the single-sequence step on slab b alone.
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
    mega_decode_step_i8_ref,
)
from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)

MAX_BATCH = 16   # rows per launch (the kernel's GEMV tile)


def mega_decode_step_batch_ref(pack, cfg: DecoderConfig, tokens_or_x, pos,
                               k, v, k_s, v_s):
    """Plain version of the kernels: the single-sequence plain step on each
    row's slab, on any device. `pos` is a host sequence of B ints. Writes
    row pos[b] of slab b in place. -> (tokens int32 [B], h f32 [B, H])."""
    toks, hs = [], []
    for b, p in enumerate(_host_pos(pos)):
        t, h = mega_decode_step_i8_ref(pack, cfg, tokens_or_x[b:b + 1], int(p),
                                       k[b], v[b], k_s[b], v_s[b])
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
    B slabs: validates the pack and the pool once, allocates the scratch
    once, then launches a step per call."""

    def __init__(self, pack, cfg: DecoderConfig, k, v, k_s, v_s):
        from qwen3_asr_tpu_torch.ops.build import kernel

        dev = k.device
        require_cuda(k, "k cache")
        B, L, S, _ = k.shape
        if not 1 <= B <= MAX_BATCH:
            raise ValueError(f"batch {B} outside [1, {MAX_BATCH}]")
        _check_pack(pack, cfg, dev)
        DKV, NKV = cfg.n_kv_heads * cfg.head_dim, cfg.n_kv_heads
        check(k, "k cache", torch.int8, (B, cfg.n_layers, S, DKV), dev)
        check(v, "v cache", torch.int8, (B, cfg.n_layers, S, DKV), dev)
        check(k_s, "k scales", torch.float32, (B, cfg.n_layers, S, NKV), dev)
        check(v_s, "v scales", torch.float32, (B, cfg.n_layers, S, NKV), dev)
        self.cfg, self.dev, self.B, self.S = cfg, dev, B, S
        self.pack = pack
        self._fn = kernel("qw_mega_decode_step_batch_i8",
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
                          k_scale=k_s.data_ptr(), v_scale=v_s.data_ptr(),
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
        lo, hi = (int(b) for b in bounds)
        if not 1 <= lo <= hi < self.S:
            raise ValueError(f"positions bounded by [{lo}, {hi}] are not "
                             f"inside [1, {self.S})")
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
        raise_on_error(rc, "mega_decode_step_batch")
        mega_decode_step_batch.launches += 1


def mega_decode_step_batch(pack, cfg: DecoderConfig, tokens_or_x, pos,
                           k, v, k_s, v_s):
    """One greedy decode step of B <= 16 sequences, int4 weights and int8
    KV. `tokens_or_x` is int32 [B] tokens (their embedding rows are
    gathered on the device) or bf16 [B, H] embedded rows; `pos` a host
    sequence of B positions, each in [1, S). Writes row pos[b] of slab b in
    place. -> (next tokens int32 [B], h f32 [B, H], the hidden states before
    the final norm). CPU tensors take the plain version; CUDA tensors launch
    the kernels or raise."""
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


mega_decode_step_batch.launches = 0
