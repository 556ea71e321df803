"""Where the time goes in one decode step, on the card.

    python3 -m qwen3_asr_tpu_torch.profile_decode [--quantize q8_0|int8pc|int4]
                                                  [--kv-cache bf16|int8|int4] [--no-pdl]

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
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _steps(run, pos0)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / STEPS * 1e3
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            kernels[evt.key] = (dev_us / STEPS, evt.count / STEPS)
    return window, kernels


if __name__ == "__main__":
    sys.exit(main())
