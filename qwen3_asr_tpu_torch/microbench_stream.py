"""Weight-stream microbenchmarks of the decode step: the CUDA kernels
`csrc/microbench_stream.cu` (K9-K11 on Hopper) and their plain twins.

    python -m qwen3_asr_tpu_torch.microbench_stream [--chunks 284] [--cols 2048]

Port of scripts/microbench_stream.py (K9) and of the ring benches and int4
probes of scripts/probe_int4.py (K10) and scripts/probe_int4b.py (K11). The
TPU scripts timed an HBM -> VMEM DMA ring with the megakernel's GEMV
attached; these modes time the same stream on the card: `read` (16-byte
vector loads) and `read_ring` (a cp.async ring in shared memory), each
summing every weight byte; `int8_m1` / `int8_m8` (dp4a GEMV of 1 or 8 int8
rows, one f32 scale per column); `bf16_m8` (weights converted to bf16, f32
FMA); `int4_m1` (the port's nibble pack with a scale per 512-row group);
and `unpack_nibbles`, the nibble-order probe, held bit-equal to
`ops/megakernel.py::unpack_nibbles`. T1 / T2 of probe_int4.py (XLA's int4
dtype as a jit argument, Mosaic's int4 DMA) ask about the TPU's compiler and
have no card counterpart beyond that probe.

Data: n_chunks x [1024, C] int8 chunks (the default, 284 x [1024, 2048], is
0.596 GB: the int8 decode step's weights, 28 layers of 15.7 MB plus the
155.6 MB lm head, too large for the 50 MB L2), x rows drawn from [-8, 8) as
the TPU script draws them, f32 scales; the int4 stream has the same chunk
count at half the bytes. Each wrapper takes CPU tensors to its twin and
launches its kernel on CUDA tensors (or raises), and counts its launches.
The integer modes are exact (int32 sums wrap mod 2^32 on both sides); bf16_m8
sums f32 products in another order.

Prints, per mode: ms per pass (CUDA events over `iters` passes, after a
warm-up), GB/s and its share of 3.35 TB/s, then a JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from qwen3_asr_tpu_torch.ops.megakernel import unpack_nibbles
from qwen3_asr_tpu_torch.ops.support import check, raise_on_error, require_cuda, stream_ptr

IN = 1024                 # rows of one int8 chunk (the TPU script's IN)
GROUP = 512               # int4 rows per scale
HBM_BPS = 3.35e12         # H100 SXM device memory bytes/s (NVIDIA's data sheet)
GEMV_MODES = {"int8_m1": 1, "int8_m8": 8, "bf16_m8": 0}
MODES = ("read", "read_ring", "int8_m1", "int8_m8", "bf16_m8", "int4_m1",
         "unpack_nibbles")


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def read_ref(w: torch.Tensor) -> torch.Tensor:
    """Sum of every int8 byte of w -> int64 [1]."""
    return w.reshape(-1).to(torch.int64).sum().reshape(1)


def _wrap32(a: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, the kernels' int32 sums."""
    return (((a + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int32)


def gemv_ref(mode: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """x [M, 1024] int8, w [n_chunks, 1024, C] int8, s [C] f32 -> [M, C]
    f32: f32(sum over chunks and rows of x w) * s. int8 modes: the int32 sum
    (exact, wrapped); bf16_m8: an f32 sum (float64 here, rounded once)."""
    xd = x.double()
    tot = torch.zeros(x.shape[0], w.shape[2], dtype=torch.float64, device=w.device)
    for i in range(w.shape[0]):   # chunk by chunk: float64 products are exact
        tot += xd @ w[i].double()
    if mode == "bf16_m8":
        return tot.float() * s
    return _wrap32(tot.to(torch.int64)).float() * s


def gemv_i4_ref(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """x [1024] int8, w4 [n_chunks, 512, C] nibble bytes, s4 [n_chunks, 2, C]
    f32 -> [n_chunks, C] f32: per chunk f32(dot_0) * s_0 + f32(dot_1) * s_1,
    dot_g over rows [512 g, 512 g + 512)."""
    out = []
    xd = x.double()
    for i in range(w4.shape[0]):
        w8 = unpack_nibbles(w4[i]).double()
        t = [(xd[g * GROUP:(g + 1) * GROUP] @ w8[g * GROUP:(g + 1) * GROUP]).float()
             * s4[i, g] for g in range(2)]
        out.append(t[0] + t[1])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _fn(name: str, argtypes: list):
    from qwen3_asr_tpu_torch.ops.build import kernel

    return kernel(name, argtypes)


_P = ctypes.c_void_p


def _read(w: torch.Tensor, ring: bool, counter) -> torch.Tensor:
    if w.device.type == "cpu":
        return read_ref(w)
    require_cuda(w, "w")
    check(w, "w", torch.int8, device=w.device)
    if w.numel() % 16:
        raise ValueError("w must hold a multiple of 16 bytes")
    out = torch.zeros(1, dtype=torch.int64, device=w.device)
    rc = _fn("qw_mb_read", [_P, ctypes.c_size_t, _P, ctypes.c_int, _P])(
        w.data_ptr(), w.numel() // 16, out.data_ptr(), int(ring), stream_ptr(w.device))
    raise_on_error(rc, counter.__name__)
    counter.launches += 1
    return out


def stream_read(w: torch.Tensor) -> torch.Tensor:
    """K9 `read`: the sum of every byte of w (int8, contiguous, a multiple
    of 16 bytes) -> int64 [1], through 16-byte vector loads."""
    return _read(w, False, stream_read)


def stream_read_ring(w: torch.Tensor) -> torch.Tensor:
    """K9 `read_ring`: the same sum through the cp.async ring."""
    return _read(w, True, stream_read_ring)


class StreamGemv:
    """K9's GEMV modes bound to one x / w / s: validates once, holds the
    zeroed cross-block scratch (left zero by every launch), launches per
    call. `mode` is int8_m1, int8_m8 or bf16_m8."""

    def __init__(self, mode: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor):
        dev = w.device
        require_cuda(w, "w")
        M = 8 if mode.endswith("m8") else 1
        n_chunks, _, C = w.shape
        check(x, "x", torch.int8, (M, IN), dev)
        check(w, "w", torch.int8, (n_chunks, IN, C), dev)
        check(s, "s", torch.float32, (C,), dev)
        if C % 64:
            raise ValueError(f"C={C} must be a multiple of 64")
        self.mode, self.args = mode, (x, w, s)
        acc_dt = torch.float32 if mode == "bf16_m8" else torch.int32
        self.acc = torch.zeros(M, C, dtype=acc_dt, device=dev)
        self.tiles = torch.zeros(C // 64, dtype=torch.int32, device=dev)
        self.out = torch.empty(M, C, dtype=torch.float32, device=dev)
        self._fn = _fn("qw_mb_gemv", [ctypes.c_int, _P, _P, _P, ctypes.c_int,
                                      ctypes.c_int, _P, _P, _P, _P])

    def __call__(self) -> torch.Tensor:
        x, w, s = self.args
        rc = self._fn(GEMV_MODES[self.mode], x.data_ptr(), w.data_ptr(), s.data_ptr(),
                      w.shape[0], w.shape[2], self.acc.data_ptr(), self.tiles.data_ptr(),
                      self.out.data_ptr(), stream_ptr(w.device))
        raise_on_error(rc, f"stream_gemv {self.mode}")
        stream_gemv.launches += 1
        return self.out


def stream_gemv(mode: str, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor
                ) -> torch.Tensor:
    """K9 `int8_m1` / `int8_m8` / `bf16_m8` (gemv_ref's function)."""
    if w.device.type == "cpu":
        return gemv_ref(mode, x, w, s)
    return StreamGemv(mode, x, w, s)().clone()


def stream_gemv_i4(x: torch.Tensor, w4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """K10 `int4_m1` (gemv_i4_ref's function)."""
    if w4.device.type == "cpu":
        return gemv_i4_ref(x, w4, s4)
    dev = w4.device
    require_cuda(w4, "w4")
    n_chunks, _, C = w4.shape
    check(x, "x", torch.int8, (IN,), dev)
    check(w4, "w4", torch.uint8, (n_chunks, IN // 2, C), dev)
    check(s4, "s4", torch.float32, (n_chunks, 2, C), dev)
    if C % 64:
        raise ValueError(f"C={C} must be a multiple of 64")
    out = torch.empty(n_chunks, C, dtype=torch.float32, device=dev)
    rc = _fn("qw_mb_gemv_i4", [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P])(
        x.data_ptr(), w4.data_ptr(), s4.data_ptr(), n_chunks, C, out.data_ptr(),
        stream_ptr(dev))
    raise_on_error(rc, "stream_gemv_i4")
    stream_gemv_i4.launches += 1
    return out


def unpack_probe(b: torch.Tensor) -> torch.Tensor:
    """K11's nibble-order probe: bytes [R, N] uint8 -> int8 [2R, N] (row 2r
    the sign-extended low nibble of byte row r, row 2r + 1 the high one), as
    unpack_nibbles."""
    if b.device.type == "cpu":
        return unpack_nibbles(b)
    require_cuda(b, "b")
    R, N = b.shape
    check(b, "b", torch.uint8, (R, N), b.device)
    if N % 16:
        raise ValueError(f"N={N} must be a multiple of 16")
    out = torch.empty(2 * R, N, dtype=torch.int8, device=b.device)
    rc = _fn("qw_mb_unpack", [_P, _P, ctypes.c_int, ctypes.c_int, _P])(
        b.data_ptr(), out.data_ptr(), R, N, stream_ptr(b.device))
    raise_on_error(rc, "unpack_probe")
    unpack_probe.launches += 1
    return out


stream_read.launches = 0
stream_read_ring.launches = 0
stream_gemv.launches = 0
stream_gemv_i4.launches = 0
unpack_probe.launches = 0


# ---------------------------------------------------------------------------
# data and the run
# ---------------------------------------------------------------------------

def make_data(n_chunks: int, C: int, device, seed: int = 0) -> dict:
    """The stream's inputs, drawn on `device` from a seeded generator: w
    [n_chunks, 1024, C] int8, w4 [n_chunks, 512, C] nibble bytes, x8 [8,
    1024] in [-8, 8), scales s [C] and s4 [n_chunks, 2, C] in [0, 1), and a
    [256, C] byte tile for the unpack probe."""
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dt):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=dt)

    return {"w": ints(-127, 128, (n_chunks, IN, C), torch.int8),
            "w4": ints(0, 256, (n_chunks, IN // 2, C), torch.uint8),
            "x8": ints(-8, 8, (8, IN), torch.int8),
            "s": torch.rand(C, generator=g, device=device),
            "s4": torch.rand(n_chunks, 2, C, generator=g, device=device),
            "tile": ints(0, 256, (256, C), torch.uint8)}


def mode_bytes(mode: str, d: dict) -> int:
    """Bytes a pass of `mode` must move: the weights and their scales read
    once (x and the small outputs beside them), the unpack probe's input
    read and output written."""
    w, w4 = d["w"], d["w4"]
    if mode in ("read", "read_ring"):
        return w.numel()
    if mode in GEMV_MODES:
        M = 1 if mode == "int8_m1" else 8
        return w.numel() + 4 * d["s"].numel() + M * IN + 4 * M * w.shape[2]
    if mode == "int4_m1":
        return w4.numel() + 4 * d["s4"].numel() + IN + 4 * w4.shape[0] * w4.shape[2]
    return 3 * d["tile"].numel()


def mode_ops(mode: str, d: dict) -> float:
    """Operations of a pass: 2 per multiply-add (per weight and row), 1 per
    byte summed."""
    if mode in ("read", "read_ring"):
        return float(d["w"].numel())
    if mode in GEMV_MODES:
        return 2.0 * d["w"].numel() * (1 if mode == "int8_m1" else 8)
    if mode == "int4_m1":
        return 4.0 * d["w4"].numel()
    return float(d["tile"].numel())


def runner(mode: str, d: dict):
    """(kernel call, twin call) of `mode` on d's tensors."""
    x8, w, s = d["x8"], d["w"], d["s"]
    if mode in ("read", "read_ring"):
        fn = stream_read_ring if mode == "read_ring" else stream_read
        return (lambda: fn(w)), (lambda: read_ref(w))
    if mode in GEMV_MODES:
        x = x8[:1].contiguous() if mode == "int8_m1" else x8
        if w.device.type == "cpu":
            return (lambda: stream_gemv(mode, x, w, s)), (lambda: gemv_ref(mode, x, w, s))
        step = StreamGemv(mode, x, w, s)
        return step, (lambda: gemv_ref(mode, x, w, s))
    if mode == "int4_m1":
        x1 = x8[0].contiguous()
        return ((lambda: stream_gemv_i4(x1, d["w4"], d["s4"])),
                (lambda: gemv_i4_ref(x1, d["w4"], d["s4"])))
    return (lambda: unpack_probe(d["tile"])), (lambda: unpack_nibbles(d["tile"]))


def max_err(mode: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """|kernel - twin|, max: 0 where the mode is exact."""
    return float((got.double() - want.double()).abs().max())


def tolerance(mode: str, want: torch.Tensor) -> float:
    """0 for the integer modes; bf16_m8 sums f32 products in another order,
    exact below 2^24 and rounded past it: 1e-6 of the largest |twin|."""
    return 1e-6 * float(want.abs().max()) if mode == "bf16_m8" else 0.0


def time_mode(fn, iters: int) -> float:
    """ms per pass: CUDA events around `iters` passes after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_modes(d: dict, modes=MODES) -> dict:
    """Each mode's kernel against its twin on d -> {mode: max_abs_err};
    raises on a mismatch."""
    errs = {}
    for mode in modes:
        fn, ref = runner(mode, d)
        got, want = fn(), ref()
        torch.cuda.synchronize()
        errs[mode] = max_err(mode, got, want)
        if not errs[mode] <= tolerance(mode, want):
            raise AssertionError(f"{mode}: kernel differs from its twin by {errs[mode]}")
    return errs


def time_modes(d: dict, iters: int, modes=MODES) -> dict:
    """Each mode timed on d (one warm-up, then `iters` passes) -> {mode: {ms,
    gb_s, hbm_share, bytes}}, printed a line per mode."""
    out = {}
    for mode in modes:
        ms = time_mode(runner(mode, d)[0], iters)
        nbytes = mode_bytes(mode, d)
        gbs = nbytes / (ms * 1e-3) / 1e9
        out[mode] = {"ms": ms, "gb_s": gbs, "hbm_share": gbs * 1e9 / HBM_BPS,
                     "bytes": nbytes}
        print(f"{mode:15s}: {ms:8.4f} ms/pass  {gbs:8.1f} GB/s  "
              f"({100 * gbs * 1e9 / HBM_BPS:5.1f}% of 3.35 TB/s; "
              f"{nbytes / 1e9:.4f} GB)", flush=True)
    return out


def run(n_chunks: int = 284, C: int = 2048, iters: int = 10, modes=MODES,
        seed: int = 0) -> dict:
    """Every mode held against its twin, then timed, on the card. ->
    {mode: {ms, gb_s, hbm_share, bytes, max_abs_err}}. Fails on a mismatch,
    and without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the stream microbenchmark times the CUDA card")
    d = make_data(n_chunks, C, "cuda", seed)
    errs = check_modes(d, modes)
    out = time_modes(d, iters, modes)
    for mode in modes:
        out[mode]["max_abs_err"] = errs[mode]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="decode-step weight-stream microbenchmarks")
    p.add_argument("--chunks", type=int, default=284,
                   help="[1024, C] int8 chunks per pass (284 x 2 MB = the int8 step)")
    p.add_argument("--cols", type=int, default=2048, help="chunk width C")
    p.add_argument("--iters", type=int, default=10, help="timed passes per mode")
    p.add_argument("--modes", default=",".join(MODES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("microbench_stream: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or torch.cuda.get_device_name(0)
    print(card, flush=True)
    res = run(args.chunks, args.cols, args.iters, tuple(args.modes.split(",")))
    print(json.dumps({"card": card, "chunks": args.chunks, "cols": args.cols,
                      "modes": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
