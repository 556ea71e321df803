"""Where the time goes in one decode step of the per-layer path, on the card.

    python3 -m qwen3_asr_tpu_torch.profile_decode [--kv-cache bf16|int8]

Builds Qwen3-ASR-0.6B's decoder at full width and depth with random Q8_0
weights (seed 0), fills POS cache rows with random K/V, and runs STEPS greedy
decode steps of `generate_greedy`'s per-layer loop (`decode_token`:
`decoder_forward` at T = 1, the lm head, the argmax written on the device)
at positions POS, POS + 1, ...:

1. host clock, no profiler: the enqueue time per step (the host's time to
   issue a step's launches) and the wall time per step once the device has
   finished;
2. `torch.profiler` over STEPS further steps: the device time of each kernel
   per step and its share, the device busy share of the profiled window.

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


def _steps(dec, dcfg, cache, pos0: int, out) -> None:
    from qwen3_asr_tpu_torch.models.generate import decode_token

    for i in range(1, STEPS + 1):
        decode_token(dec, dcfg, cache, out, i, pos0 + i - 1)


def main(argv=None) -> int:
    import torch

    from qwen3_asr_tpu_torch.config import DecoderConfig
    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows, init_kv_cache
    from qwen3_asr_tpu_torch.runtime.params import (
        fuse_decoder_params,
        init_decoder_params,
        quantize_decoder_params,
    )

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kv-cache", default="bf16", choices=["bf16", "int8"])
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
    dec = fuse_decoder_params(quantize_decoder_params(dec, "q8_0"))
    n = STEPS
    S = -(-(POS + 3 * n) // 128) * 128
    dt = torch.int8 if args.kv_cache == "int8" else torch.bfloat16
    cache = init_kv_cache(dcfg, S, "cuda", dt)
    fill = torch.randn(dcfg.n_layers, POS, dcfg.n_kv_heads, dcfg.head_dim,
                       generator=gen, device="cuda") * 0.5
    if dt == torch.int8:
        for name in ("k", "v"):
            q, s = _quantize_kv_rows(fill)
            cache[name][:, :POS], cache[name + "_s"][:, :POS] = q, s
    else:
        cache["k"][:, :POS] = cache["v"][:, :POS] = fill.to(dt)
    out = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    out[0] = 1000

    _steps(dec, dcfg, cache, POS, out)                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _steps(dec, dcfg, cache, POS + n, out)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    enqueue, wall = t_enq / n * 1e3, t_wall / n * 1e3
    print(f"q8_0 weights, {args.kv_cache} cache, pos {POS + n}..{POS + 2 * n - 1}:"
          f" enqueue {enqueue:.4f} ms/step, wall {wall:.4f} ms/step (no profiler)",
          flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _steps(dec, dcfg, cache, POS + 2 * n, out)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) / n * 1e3
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            kernels[evt.key] = (dev_us / n, evt.count / n)
    device = sum(us for us, _ in kernels.values()) / 1e3
    if not device:
        raise RuntimeError("the profiler recorded no device time")
    print(f"profiled window {window:.4f} ms/step, device {device:.4f} ms/step, "
          f"busy {device / window:.3f}", flush=True)
    for name, (us, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us:9.2f} us/step {100 * us / 1e3 / device:5.1f}%  "
              f"{cnt:6.1f} launches/step  {name[:110]}", flush=True)
    print(json.dumps({"card": smi, "quantize": "q8_0", "kv_cache": args.kv_cache,
                      "pos": POS, "steps": n, "enqueue_ms": enqueue,
                      "wall_ms": wall, "window_ms": window, "device_ms": device,
                      "kernels_us": {k: v[0] for k, v in kernels.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
