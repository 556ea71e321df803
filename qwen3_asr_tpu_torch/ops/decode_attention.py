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
`offset` and `pos` are host ints: they size the kernel's grid. With
`store=True` the same launch also writes k_new / v_new into cache row
`offset` in the cache's format, bit-equal to `store_kv_rows` (the twins
store through it; so does `models/decoder.py::_store`): one launch a layer
in the decode step, where the reference stores after its kernel through
`dynamic_update_slice`.

`decode_attention_batch` is the same kernel over B rows (the reference runs
`decode_attention` under `jax.vmap` in its batched per-layer step): qkv [B,
...], caches [B, S, n_kv, D] (scales [B, S, n_kv]) whose slabs may lie any
whole stride apart (layer l of the batched decode's [B, L, S, n_kv * D]
cache), offsets and positions int32 [B] on the tensors' device, read
there, and a host bound >= every offset that sizes the grid. Row b is the
one-row call on slab b.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qwen3_asr_tpu_torch.ops.q8_matmul import INV127, rms_norm_f32
from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)


# The head dims the kernel is built for (the twins take any).
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)


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


def _quantize_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, n_kv, hd] float -> (int8 rows, f32 scales [T, n_kv])."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1) * INV127, min=1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def store_kv_rows(k_cache, v_cache, k_scale, v_scale, rows, k, v) -> None:
    """Write fresh K/V rows k / v ([..., n_kv, hd] float) into the caches at
    `rows` (an int, a slice, or a tuple of index tensors), in the cache's
    format: bf16 rounded to nearest even, or int8 codes with their f32
    scales (`_quantize_kv_rows`; k_scale / v_scale None for a bf16 cache).
    A cache whose indexed rows are flat ([..., n_kv * hd], the batched
    decode's pool) takes the rows flattened. In place."""
    n_idx = len(rows) if isinstance(rows, tuple) else 1
    for cache, scale, x in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
        flat = cache.dim() - n_idx == 1
        if scale is not None:
            q, s = _quantize_kv_rows(x)
            cache[rows] = q.flatten(-2) if flat else q
            scale[rows] = s
        else:
            cache[rows] = (x.flatten(-2) if flat else x).to(cache.dtype)


def _check_store(S: int, offsets) -> None:
    if any(o >= S for o in offsets):
        raise ValueError(f"store=True writes cache row offset: every offset must "
                         f"be < S = {S} (got {list(offsets)})")


def check_store(what: str, call, caches: dict, rows, view=lambda t: t) -> None:
    """The in-kernel store against `store_kv_rows` (what
    `models/decoder.py::_store` runs): call(caches, store) on a copy of the
    caches ("k", "v" and, int8, "k_s", "v_s") with store on and on another
    with it off. The outputs must be torch.equal, and the first copy
    torch.equal to the second after `store_kv_rows` of the call's own k_new
    / v_new at `rows` of view(cache), the tensors the call reads (a layer
    of the batched decode's pool, say)."""
    on = {n: t.clone() for n, t in caches.items()}
    off = {n: t.clone() for n, t in caches.items()}
    got, plain = call(on, True), call(off, False)
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        raise AssertionError(f"{what}: the outputs with the store on differ from those "
                             f"with it off")
    k_new, v_new = plain[1], plain[2]
    if not isinstance(rows, tuple):
        k_new, v_new = k_new[0], v_new[0]
    store_kv_rows(*(view(off[n]) if n in off else None for n in ("k", "v", "k_s", "v_s")),
                  rows, k_new, v_new)
    bad = [n for n in caches if not torch.equal(on[n], off[n])]
    if bad:
        raise AssertionError(f"{what}: the in-kernel store differs from store_kv_rows "
                             f"in {bad}")


def decode_attention_ref(qkv, k_cache, v_cache, q_norm, k_norm, offset: int,
                         pos: int, *, n_heads: int, n_kv: int, head_dim: int,
                         eps: float, theta: float, scale: float,
                         k_scale=None, v_scale=None, store: bool = False):
    """Plain twin of the kernel: the Pallas body's f32 math on the live
    rows < offset (the body's masked rows add exp(-0.7 max) = 0 exactly);
    store=True then writes k_new / v_new at cache row offset through
    `store_kv_rows`."""
    D, group = head_dim, n_heads // n_kv
    if store:
        _check_store(k_cache.shape[0], [offset])
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
    if store:
        store_kv_rows(k_cache, v_cache, k_scale, v_scale, offset, k_all, v_all)
    return attn, k_all.reshape(1, n_kv, D), v_all.reshape(1, n_kv, D)


# Per device: the kernel's ticket counters, one per (row, KV head), zero
# between launches (the block that merges a pair resets its counter), so one
# buffer serves every call on the device's stream and every replay of a
# captured graph. Calls on two streams at once would share it: the port
# launches K4 on one stream.
_TICKETS: dict = {}


def _tickets(dev: torch.device, n: int) -> torch.Tensor:
    t = _TICKETS.get(dev)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_attention: its ticket counters are allocated "
                               "on the first call; make one call before a graph "
                               "capture")
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _TICKETS[dev] = t
    return t


def _scratch(n_heads: int, n_kv: int, D: int, bound: int, B: int) -> int:
    from qwen3_asr_tpu_torch.ops.build import kernel

    return int(kernel("qw_decode_attention_scratch", [ctypes.c_int] * 5,
                      ctypes.c_size_t)(n_heads, n_kv, D, bound, B))


def _check_common(qkv, q_norm, k_norm, rows, n_heads, n_kv, D, dev):
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qkv: expected bfloat16 or float32, got {qkv.dtype}")
    check(qkv, "qkv", qkv.dtype, (rows, (n_heads + 2 * n_kv) * D), dev)
    if q_norm.dtype != k_norm.dtype or q_norm.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("q_norm / k_norm: expected one dtype, bfloat16 or float32")
    check(q_norm, "q_norm", q_norm.dtype, (D,), dev)
    check(k_norm, "k_norm", k_norm.dtype, (D,), dev)


def _check_cache(k_cache, v_cache, k_scale, v_scale, lead: tuple, n_kv, D, dev):
    """The caches [*lead, n_kv, D] (bf16, or int8 with f32 scales [*lead,
    n_kv]). -> whether the cache is int8."""
    quant = k_scale is not None
    cdt = torch.int8 if quant else torch.bfloat16
    check(k_cache, "k_cache", cdt, (*lead, n_kv, D), dev)
    check(v_cache, "v_cache", cdt, (*lead, n_kv, D), dev)
    if quant:
        check(k_scale, "k_scale", torch.float32, (*lead, n_kv), dev)
        check(v_scale, "v_scale", torch.float32, (*lead, n_kv), dev)
    return quant


def _check_slabs(k_cache, v_cache, k_scale, v_scale, n_kv, D, dev) -> tuple[bool, int]:
    """B cache slabs [B, S, n_kv, D] (bf16, or int8 with f32 scales [B, S,
    n_kv]), each slab contiguous, slab b + 1 a fixed stride after slab b, the
    same for K, V and their scales. -> (whether the cache is int8, the
    stride in (row, head) pairs)."""
    quant = k_scale is not None
    B, S = k_cache.shape[:2]
    inner = (n_kv * D, D, 1)
    slab = k_cache.stride(0) // D if B > 1 else S * n_kv
    for name, t, dt, shape, strides in (
            ("k_cache", k_cache, torch.int8 if quant else torch.bfloat16, (B, S, n_kv, D),
             (slab * D, *inner)),
            ("v_cache", v_cache, torch.int8 if quant else torch.bfloat16, (B, S, n_kv, D),
             (slab * D, *inner)),
            *((("k_scale", k_scale, torch.float32, (B, S, n_kv), (slab, n_kv, 1)),
               ("v_scale", v_scale, torch.float32, (B, S, n_kv), (slab, n_kv, 1)))
              if quant else ())):
        check(t[0], name + "[0]", dt, shape[1:], dev)
        if tuple(t.shape) != shape or (B > 1 and tuple(t.stride()) != strides) \
                or slab < S * n_kv:
            raise ValueError(f"{name}: expected slabs {shape} at (row, head) stride "
                             f"{slab}, got {tuple(t.shape)} strides {tuple(t.stride())}")
    return quant, slab


def _launch(qkv, k_cache, v_cache, q_norm, k_norm, offset, pos, n_heads, n_kv,
            D, eps, theta, scale, k_scale, v_scale, store):
    from qwen3_asr_tpu_torch.ops.build import kernel

    dev = qkv.device
    S = k_cache.shape[0]
    _check_common(qkv, q_norm, k_norm, 1, n_heads, n_kv, D, dev)
    quant = _check_cache(k_cache, v_cache, k_scale, v_scale, (S,), n_kv, D, dev)
    if n_heads % n_kv or D not in KERNEL_HEAD_DIMS or not 0 <= offset <= S:
        raise ValueError(f"decode_attention takes n_heads % n_kv == 0, D in "
                         f"{KERNEL_HEAD_DIMS}, 0 <= offset <= S (got {n_heads}, "
                         f"{n_kv}, {D}, offset {offset}, S {S})")
    if store:
        _check_store(S, [offset])
    cnt = _tickets(dev, n_kv)
    n_part = _scratch(n_heads, n_kv, D, offset, 1)
    part = torch.empty(max(int(n_part), 1), dtype=torch.float32, device=dev)
    attn = torch.empty(1, n_heads * D, dtype=torch.float32, device=dev)
    k_new = torch.empty(1, n_kv, D, dtype=torch.float32, device=dev)
    v_new = torch.empty(1, n_kv, D, dtype=torch.float32, device=dev)
    fn = kernel("qw_decode_attention",
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, q_norm.data_ptr(), k_norm.data_ptr(),
            int(q_norm.dtype == torch.bfloat16), part.data_ptr(), cnt.data_ptr(),
            attn.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), S, int(offset), int(pos),
            n_heads, n_kv, D, float(eps), rope_coef(theta, D), float(np.float32(scale)),
            int(store), stream_ptr(dev))
    raise_on_error(rc, "decode_attention")
    return attn, k_new, v_new


def decode_attention(qkv, k_cache, v_cache, q_norm, k_norm, offset: int, pos: int,
                     *, n_heads: int, n_kv: int, head_dim: int, eps: float,
                     theta: float, scale: float, k_scale=None, v_scale=None,
                     store: bool = False):
    """-> (attn [1, n_heads * D] f32, k_new [1, n_kv, D] f32, v_new [1, n_kv,
    D] f32). store=True also writes k_new / v_new into cache row offset (<
    S) in the cache's format, in the same launch. CPU tensors take the
    twin; CUDA tensors launch the kernel or raise."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps,
              theta=theta, scale=scale, k_scale=k_scale, v_scale=v_scale, store=store)
    if k_cache.device.type == "cpu":
        return decode_attention_ref(qkv, k_cache, v_cache, q_norm, k_norm,
                                    int(offset), int(pos), **kw)
    require_cuda(k_cache, "k_cache")
    out = _launch(qkv.contiguous(), k_cache, v_cache, q_norm.contiguous(),
                  k_norm.contiguous(), int(offset), int(pos), n_heads, n_kv,
                  head_dim, eps, theta, scale, k_scale, v_scale, bool(store))
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_batch_ref(qkv, k_cache, v_cache, q_norm, k_norm, offsets, pos,
                               *, n_heads: int, n_kv: int, head_dim: int, eps: float,
                               theta: float, scale: float, k_scale=None, v_scale=None,
                               store: bool = False):
    """Plain twin of the batched kernel: decode_attention_ref on each row's
    slab at its own offset and position (host ints read from `offsets` and
    `pos`), storing each row's fresh K/V at its offset when store=True."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps, theta=theta,
              scale=scale, store=store)
    if store:
        _check_store(k_cache.shape[1], _host_ints(offsets))
    outs = [decode_attention_ref(
        qkv[b:b + 1], k_cache[b], v_cache[b], q_norm, k_norm, int(o), int(p), **kw,
        k_scale=None if k_scale is None else k_scale[b],
        v_scale=None if v_scale is None else v_scale[b])
        for b, (o, p) in enumerate(zip(_host_ints(offsets), _host_ints(pos)))]
    return tuple(torch.cat(t) for t in zip(*outs))


def _host_ints(x) -> list[int]:
    return [int(v) for v in (x.tolist() if isinstance(x, torch.Tensor) else x)]


def decode_attention_batch(qkv, k_cache, v_cache, q_norm, k_norm, offsets: torch.Tensor,
                           pos: torch.Tensor, bound: int, *, n_heads: int, n_kv: int,
                           head_dim: int, eps: float, theta: float, scale: float,
                           k_scale=None, v_scale=None, store: bool = False):
    """B rows in one launch: qkv [B, (n_heads + 2 n_kv) * D]; k_cache /
    v_cache [B, S, n_kv, D] (bf16, or int8 with k_scale / v_scale [B, S,
    n_kv] f32), each slab contiguous and the slabs one stride apart;
    offsets and pos int32 [B] on the caches' device; `bound` a
    host int >= every offset (<= S) that sizes the grid. -> (attn [B,
    n_heads * D] f32, k_new [B, n_kv, D] f32, v_new [B, n_kv, D] f32).
    store=True also writes row b's k_new / v_new into row offsets[b] of
    slab b in the same launch; every offset, and so the bound, must then be
    < S (a bound of S raises: the kernel does not read the offsets back,
    and a row at S would store nothing). CPU tensors take the twin (reading
    the offsets on the host); CUDA tensors launch the kernel or raise, and
    the offsets are not read back."""
    kw = dict(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, eps=eps, theta=theta,
              scale=scale, k_scale=k_scale, v_scale=v_scale, store=store)
    if store and int(bound) >= k_cache.shape[1]:
        raise ValueError(f"store=True writes row offsets[b] of each slab: the bound, "
                         f"at least every offset, must be < S = {k_cache.shape[1]} "
                         f"(got {bound})")
    if k_cache.device.type == "cpu":
        return decode_attention_batch_ref(qkv, k_cache, v_cache, q_norm, k_norm,
                                          offsets, pos, **kw)
    from qwen3_asr_tpu_torch.ops.build import kernel

    require_cuda(k_cache, "k_cache")
    dev, D = k_cache.device, head_dim
    B, S = k_cache.shape[:2]
    qkv, q_norm, k_norm = qkv.contiguous(), q_norm.contiguous(), k_norm.contiguous()
    _check_common(qkv, q_norm, k_norm, B, n_heads, n_kv, D, dev)
    quant, slab = _check_slabs(k_cache, v_cache, k_scale, v_scale, n_kv, D, dev)
    check(offsets, "offsets", torch.int32, (B,), dev)
    check(pos, "pos", torch.int32, (B,), dev)
    if n_heads % n_kv or D not in KERNEL_HEAD_DIMS or not 0 <= int(bound) <= S:
        raise ValueError(f"decode_attention_batch takes n_heads % n_kv == 0, D in "
                         f"{KERNEL_HEAD_DIMS}, 0 <= bound <= S (got {n_heads}, {n_kv}, "
                         f"{D}, bound {bound}, S {S})")
    cnt = _tickets(dev, B * n_kv)
    part = torch.empty(max(_scratch(n_heads, n_kv, D, int(bound), B), 1),
                       dtype=torch.float32, device=dev)
    attn = torch.empty(B, n_heads * D, dtype=torch.float32, device=dev)
    k_new = torch.empty(B, n_kv, D, dtype=torch.float32, device=dev)
    v_new = torch.empty(B, n_kv, D, dtype=torch.float32, device=dev)
    fn = kernel("qw_decode_attention_batch",
                [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                + [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
                + [ctypes.c_longlong] + [ctypes.c_int] * 4
                + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), k_cache.data_ptr(),
            v_cache.data_ptr(), k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, q_norm.data_ptr(), k_norm.data_ptr(),
            int(q_norm.dtype == torch.bfloat16), part.data_ptr(), cnt.data_ptr(),
            attn.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), offsets.data_ptr(),
            pos.data_ptr(), B, S, slab, int(bound), n_heads, n_kv, D, float(eps),
            rope_coef(theta, D), float(np.float32(scale)), int(bool(store)),
            stream_ptr(dev))
    raise_on_error(rc, "decode_attention_batch")
    decode_attention_batch.launches += 1
    return attn, k_new, v_new


decode_attention_batch.launches = 0
