"""Where the time goes in one decode step, on the card.

    python3 -m qwen3_asr_tpu_torch.profile_decode [--quantize q8_0|int8pc|int4]
                                                  [--kv-cache bf16|int8|int4] [--no-pdl]
    python3 -m qwen3_asr_tpu_torch.profile_decode --batch 1 8 16 [--quantize int8pc|int4]
                                                  [--kv-cache int8|bf16]

Builds Qwen3-ASR-0.6B's decoder at full width and depth with random weights
(seed 0): Q8_0 weights (the default) for the per-layer path, or int8pc
weights with the int8 decode pack (`int8pc`, what `--quantize auto` runs)
or the int4 one (`int4`). Fills POS cache rows with random K/V (the int4
cache packed from int8 rows, as generate_greedy packs it; without a pack
it runs as int8), and runs
STEPS greedy decode steps of `generate_greedy`'s own loop at positions POS,
POS + 1, ...: `decode_token` (`decoder_forward` at T = 1, the lm head, the
argmax written on the device) for Q8_0, K1's `DecodeStep` for a pack:

1. host clock, no profiler: the enqueue time per step (the host's time to
   issue a step's launches) and the wall time per step once the device has
   finished;
2. `torch.profiler` over STEPS further steps: the device time of each kernel
   per step, its share and its launches per step, the device busy share of
   the profiled window;
3. for a pack, the same step as the decode loops run it, replayed from its
   CUDA graph (`GraphStep`): enqueue and wall per step, and the profiled
   window's device busy share.

With `--batch B ...` it profiles the batched step (K3, `BatchDecodeStep`)
instead, on a pack (`--quantize int8pc` or `int4`) over a pool of B slabs of BATCH_S
rows at `spread_positions(B)` (`profile_batch`): per B the eager step's
device ms (CUDA events) and host enqueue, `torch.profiler`'s device time by
kernel name, launches and busy share over STEPS steps, the step captured
once in a CUDA graph at the same positions and replayed (device ms), and
the step's bound.

Prints one line per measurement and a JSON summary last. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

POS = 1520     # the 92 s request's prompt (1,211 rows) plus ~300 tokens
STEPS = 16
BATCH_S = 1664   # the batched step's pool context (chip_smoke.py's K3 phase)
# Peaks of an H100 SXM (NVIDIA's data sheet) for the bounds: HBM bytes/s and
# int8 tensor-core operations/s.
HBM_BPS, INT8_OPS = 3.35e12, 1979e12
WEIGHT_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
               "head_q", "head_s")


def _steps(run, pos0: int) -> None:
    """STEPS steps at pos0, pos0 + 1, ...; step i reads the token at i - 1
    of the output buffer (the index runs on across calls)."""
    for i in range(1, STEPS + 1):
        run(pos0 - POS + i, pos0 + i - 1)


def main(argv=None) -> int:
    import torch

    from qwen3_asr_tpu_torch.config import DecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows, init_kv_cache
    from qwen3_asr_tpu_torch.models.generate import (
        INT4_KV,
        decode_token,
        kv_dtype,
        mega_caches,
    )
    from qwen3_asr_tpu_torch.ops.megakernel import (
        DecodeStep,
        GraphStep,
        pack_megakernel_params,
    )
    from qwen3_asr_tpu_torch.runtime.params import (
        fuse_decoder_params,
        init_decoder_params,
        quantize_decoder_params,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quantize", default="q8_0", choices=["q8_0", "int8pc", "int4"])
    p.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8", "int4"])
    p.add_argument("--batch", type=int, nargs="+", metavar="B",
                   help="profile the batched step (K3) at these batch sizes instead")
    p.add_argument("--no-pdl", action="store_true",
                   help="launch K1's GEMVs without programmatic dependent launch (the "
                        "profiler then sees each kernel alone; with it, a GEMV's time "
                        "includes its wait under its predecessor)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)

    dcfg = DecoderConfig(eos_token_id=-1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec = init_decoder_params(dcfg, gen, torch.bfloat16, "cuda")
    q8 = args.quantize == "q8_0"
    if args.batch:
        if q8 or args.kv_cache == "int4":
            p.error("--batch takes a pack (int8pc or int4) and an int8 or bf16 cache")
        dec = fuse_decoder_params(quantize_decoder_params(dec, "int8pc"))
        pack = pack_megakernel_params(dec, dcfg, int4=args.quantize == "int4")
        rows = [profile_batch(pack, dcfg, B, args.kv_cache, gen=gen) for B in args.batch]
        for r in rows:
            print(f"{args.quantize} weights, {args.kv_cache} cache, K3 B={r['B']} S={BATCH_S} "
                  f"pos={r['positions'][0]}..{r['positions'][-1]}: eager {r['eager_ms']:.4f} "
                  f"ms/step (enqueue {r['enqueue_ms']:.4f}), graphed {r['graphed_ms']:.4f}; "
                  f"profiled device {r['device_ms']:.4f} ms/step, busy {r['busy']:.3f}, "
                  f"{r['launches_per_step']:.1f} launches/step; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})", flush=True)
            for name, us in sorted(r["kernels_us"].items(), key=lambda kv: -kv[1]):
                print(f"  {us:9.2f} us/step {100 * us / 1e3 / r['device_ms']:5.1f}%  "
                      f"{r['kernels_n'][name]:6.1f} launches/step  {name[:110]}", flush=True)
        print(json.dumps({"card": smi, "quantize": args.quantize, "kv_cache": args.kv_cache,
                          "S": BATCH_S, "batch": rows}), flush=True)
        return 0
    dec = fuse_decoder_params(quantize_decoder_params(dec, "q8_0" if q8 else "int8pc"))
    n = STEPS
    S = -(-(POS + 6 * n + 2) // 128) * 128
    kv = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": INT4_KV}[args.kv_cache]
    if q8:   # no decode pack: the int4 cache runs as int8
        kv = kv_dtype(dec, kv)
    dt = torch.bfloat16 if kv == torch.bfloat16 else torch.int8
    cache = init_kv_cache(dcfg, S, "cuda", dt)
    fill = torch.randn(dcfg.n_layers, POS, dcfg.n_kv_heads, dcfg.head_dim,
                       generator=gen, device="cuda") * 0.5
    if dt == torch.int8:
        for name in ("k", "v"):
            q, s = _quantize_kv_rows(fill)
            cache[name][:, :POS], cache[name + "_s"][:, :POS] = q, s
    else:
        cache["k"][:, :POS] = cache["v"][:, :POS] = fill.to(dt)
    out = torch.zeros(6 * n + 2, dtype=torch.int32, device="cuda")
    out[0] = 1000
    graphed = None
    if q8:
        def run(i, pos):
            decode_token(dec, dcfg, cache, out, i, pos)
    else:
        pack = pack_megakernel_params(dec, dcfg, int4=args.quantize == "int4")
        step = DecodeStep(pack, dcfg, *mega_caches(dcfg, cache, kv), pdl=not args.no_pdl)
        graph_step = GraphStep(step)

        def run(i, pos):
            step(out[i - 1:i], pos, out[i:i + 1])

        def graphed(i, pos):
            graph_step(out, i, pos)

    label = f"{args.quantize} weights, {args.kv_cache} cache" + (", no PDL" if args.no_pdl
                                                                 else "")
    summary = {"card": smi, "quantize": args.quantize, "kv_cache": args.kv_cache,
               "pos": POS, "steps": n}
    _steps(run, POS)                                      # warm-up
    enqueue, wall = _timed(run, POS + n)
    print(f"{label}, pos {POS + n}..{POS + 2 * n - 1}: enqueue {enqueue:.4f} ms/step, "
          f"wall {wall:.4f} ms/step (eager, no profiler)", flush=True)
    window, kernels = _profiled(run, POS + 2 * n)
    device = sum(us for us, _ in kernels.values()) / 1e3
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    launches = sum(cnt for name, (_, cnt) in kernels.items() if "emset" not in name)
    print(f"profiled window {window:.4f} ms/step, device {device:.4f} ms/step, "
          f"busy {device / window:.3f}; {launches:.1f} kernel launches/step", flush=True)
    for name, (us, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us:9.2f} us/step {100 * us / 1e3 / device:5.1f}%  "
              f"{cnt:6.1f} launches/step  {name[:110]}", flush=True)
    summary.update(enqueue_ms=enqueue, wall_ms=wall, window_ms=window, device_ms=device,
                   launches_per_step=launches,
                   kernels_us={k: v[0] for k, v in kernels.items()})
    if graphed is not None:
        _steps(graphed, POS + 3 * n)        # warm-up: the capture, then replays
        g_enq, g_wall = _timed(graphed, POS + 4 * n)
        g_window, g_kernels = _profiled(graphed, POS + 5 * n)
        g_device = sum(us for us, _ in g_kernels.values()) / 1e3
        busy = f"busy {g_device / g_window:.3f}" if g_device else "device time not recorded"
        print(f"{label}, graphed (GraphStep, one replay a step): enqueue {g_enq:.4f} "
              f"ms/step, wall {g_wall:.4f} ms/step; profiled window {g_window:.4f} "
              f"ms/step, device {g_device:.4f} ms/step, {busy}", flush=True)
        summary["graphed"] = {"enqueue_ms": g_enq, "wall_ms": g_wall, "window_ms": g_window,
                              "device_ms": g_device or None}
    print(json.dumps(summary), flush=True)
    return 0


def _timed(run, pos0: int) -> tuple[float, float]:
    """STEPS steps from pos0 on the host clock: (enqueue ms/step, wall
    ms/step once the device has finished)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _steps(run, pos0)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    return t_enq / STEPS * 1e3, t_wall / STEPS * 1e3


def _profiled(run, pos0: int):
    """STEPS steps from pos0 under torch.profiler: (window ms/step, {kernel:
    (device us/step, launches/step)})."""
    return _profile_window(lambda: _steps(run, pos0), STEPS)


def _profile_window(run_all, n: int):
    """run_all() (n steps) under torch.profiler: (window ms/step, {kernel:
    (device us/step, launches/step)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_all()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / n * 1e3
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            kernels[evt.key] = (dev_us / n, evt.count / n)
    return window, kernels


def spread_positions(B: int) -> list[int]:
    """B cache positions spread over 64 .. 1,600 (chip_smoke.py's K3
    positions); B = 1 takes the middle one of the spread of 8."""
    import numpy as np

    if B == 1:
        return [spread_positions(8)[4]]
    return [int(p) for p in np.linspace(64, 1600, B).round()]


def step_bound(pack, dcfg, positions, kv: str = "int8") -> tuple[float, float]:
    """(bytes, operations) of a K1 / K3 step over rows at `positions`: the
    pack's weights and scales once (int4: two weights a byte; int8: one),
    each row's live cache (K and V rows < pos, all layers: int8 codes, or
    int4 codes two a byte, and their f32 scales, or bf16 values) and its
    fresh row; 2 operations per weight and row, and 4 D per (head, cached
    row) per row."""
    from qwen3_asr_tpu_torch.ops.megakernel import weight_bits

    L, NH, NKV, D = dcfg.n_layers, dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    w_bytes = sum(pack[k].numel() * pack[k].element_size() for k in WEIGHT_KEYS)
    per_byte = 2 if weight_bits(pack) == 4 else 1
    n_w = sum(per_byte * pack[k].numel() for k in WEIGHT_KEYS if k.endswith("_q"))
    row = L * {"int8": 2 * NKV * D + 2 * NKV * 4, "int4": NKV * D + 2 * NKV * 4,
               "bf16": 4 * NKV * D}[kv]
    nbytes = w_bytes + sum((p + 1) * row for p in positions)
    ops = 2.0 * n_w * len(positions) + sum(4.0 * L * NH * D * p for p in positions)
    return nbytes, ops


def filled_pool(dcfg, S: int, positions, kv: str, gen):
    """(k, v, k_s, v_s) [B, L, S, ...]: int8 codes with f32 scales, or bf16
    rows with no scales (None); slab b's rows < positions[b] random."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows

    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    B = len(positions)
    dt = torch.bfloat16 if kv == "bf16" else torch.int8
    out = [torch.zeros(B, L, S, NKV * D, dtype=dt, device="cuda") for _ in range(2)]
    scales = ([torch.zeros(B, L, S, NKV, dtype=torch.float32, device="cuda")
               for _ in range(2)] if kv == "int8" else [None, None])
    for b, p in enumerate(positions):
        for c, sc in zip(out, scales):
            x = torch.randn(L, p, NKV, D, generator=gen, device="cuda") * 0.5
            if sc is None:
                c[b, :, :p] = x.reshape(L, p, NKV * D).to(dt)
            else:
                q, s = _quantize_kv_rows(x)
                c[b, :, :p] = q.reshape(L, p, NKV * D)
                sc[b, :, :p] = s
    return out[0], out[1], scales[0], scales[1]


def profile_batch(pack, dcfg, B: int, kv: str = "int8", S: int = BATCH_S,
                  n: int = STEPS, gen=None, trace: bool = True) -> dict:
    """K3 (`BatchDecodeStep`) at B rows over a pool of S rows at
    spread_positions(B), every step at the same positions (it rewrites the
    fresh rows): the eager step's device ms/step between CUDA events and the
    host's enqueue ms/step over n steps; with `trace`, torch.profiler over n
    more steps (device us per kernel name, launches, busy share of the
    window; else those keys are None); the step captured once in a CUDA
    graph and replayed n times (device ms/step); the bound (bytes over
    HBM_BPS against operations over INT8_OPS)."""
    import torch

    from qwen3_asr_tpu_torch.ops.megakernel_batch import BatchDecodeStep

    positions = spread_positions(B)
    gen = gen or torch.Generator(device="cuda").manual_seed(0)
    pool = filled_pool(dcfg, S, positions, kv, gen)   # kept alive: the step holds pointers
    step = BatchDecodeStep(pack, dcfg, *pool)
    toks = torch.full((B,), 1000, dtype=torch.int32, device="cuda")
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    pos_d = torch.tensor(positions, dtype=torch.int32, device="cuda")
    bounds = (min(positions), max(positions))

    def run():
        step(toks, pos_d, out, bounds)

    def run_all():
        for _ in range(n):
            run()

    for _ in range(3):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    run_all()
    end.record()
    enqueue = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / n
    window, kernels, device = None, {}, None
    if trace:
        window, kernels = _profile_window(run_all, n)
        device = sum(us for us, _ in kernels.values()) / 1e3
        if not device:
            raise RuntimeError("the profiler recorded no device time")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graphed = start.elapsed_time(end) / n
    nbytes, ops = step_bound(pack, dcfg, positions, kv)
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / INT8_OPS * 1e3
    del graph, step, pool
    return {"B": B, "positions": positions, "eager_ms": eager, "enqueue_ms": enqueue,
            "graphed_ms": graphed, "window_ms": window, "device_ms": device,
            "busy": device / window if trace else None,
            "launches_per_step": (sum(c for k, (_, c) in kernels.items() if "emset" not in k)
                                  if trace else None),
            "kernels_us": {k: v[0] for k, v in kernels.items()},
            "kernels_n": {k: v[1] for k, v in kernels.items()},
            "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}


if __name__ == "__main__":
    sys.exit(main())
