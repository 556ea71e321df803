"""Run one cell of the benchmark once.

    python3 asrbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Loads the port's kernel library from `build/torch_kernels/` in the
   checkout (the first run of a checkout builds it).
2. Builds the program behind the front door the mix names
   (`asrbench/doors/`); the configuration's family (`asrbench/families/`)
   makes its weights on the device from the seed and hands them to the
   program's loader, which quantizes and packs them.
3. Warms up one request at the mix's shortest and one at its longest
   length (the server: also one full batch).
4. Drives the mix's traffic for `--seconds` (`asrbench/traffic/`); with
   `--trace 1` it then profiles a fixed count of further requests.
5. Reads the device's peak memory, frees the program, and judges a sample
   of the window's requests against the family's plain reference
   (`check.py`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or its
per-layer ones with `--trace 1`), `device`, `breakdown` (traced runs) and
`compared` (each number compared with its limit), which also end standard
error. Without a CUDA device, with a module of JAX or of the JAX package
loaded, or without the program beside it, it exits non-zero and prints no
result.

`run_cell(control=True)` runs the mix's control in the program's place
(`asrbench/tools/readings.py`, `asrbench/tests/test_asrbench_control.py`).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
# Set before torch loads: no library loads JAX by itself, and torch's host
# operators run on the one thread that drives the card, with no pool of
# OpenMP workers to wake on a host whose cores other machines share.
ENV = {"USE_FLAX": "0", "USE_JAX": "0", "OMP_NUM_THREADS": "1"}


class Run:
    """What a metric's reader reads: the cell, its shapes and family, the
    window's requests, the set-up time, the program's counters over the
    window, and the traced sub-window (None without --trace)."""

    def __init__(self, cell, kind: str, window, setup_s: float, counters: dict, trace):
        self.cell, self.kind = cell, kind
        self.config, self.mix, self.family = cell.config, cell.mix, cell.family
        self.window, self.setup_s = window, setup_s
        self.counters, self.trace = counters, trace

    @property
    def kv(self) -> str:
        return self.mix["door_args"].get("kv_cache", "bf16")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def warm(door, plan) -> None:
    """The shortest and the longest request; a server also one full batch
    of the longest."""
    for req in plan.warm_requests():
        door.call(req, plan.pcm(req))
    if hasattr(door, "warm_batch"):
        longest = plan.warm_requests()[-1]
        n = plan.mix["door_args"]["max_batch"]
        door.warm_batch([longest] * n, [plan.pcm(longest)] * n)


def drive(door, plan, mix: dict, seconds: float):
    from asrbench.traffic import loops

    if mix["loop"] == "closed":
        return loops.closed(door, plan, seconds)
    return loops.open_loop(door, plan, plan.schedule(seconds))


def traced(door, plan, mix: dict):
    """The profiled sub-window: trace_requests more requests of the mix."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from asrbench.trace import WINDOW_SPAN, Trace
    from asrbench.traffic import TRACE_STREAM, loops

    n = int(mix["trace_requests"])
    first_batch = len(getattr(door, "batches", []))
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            if mix["loop"] == "closed":
                win = loops.closed(door, plan, None, count=n, stream=TRACE_STREAM)
            else:
                reqs = plan.schedule(n / float(mix["rate_per_s"]), stream=TRACE_STREAM)
                win = loops.open_loop(door, plan, reqs)
            sync()
    batches = getattr(door, "batches", [])[first_batch:]
    return Trace(prof, win.requests, batches)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False, t_start: float | None = None,
             read_metrics: bool = True) -> dict:
    """One run of `cell`; -> the result object (without printing it).
    read_metrics=False leaves `metrics` empty (a check-only run)."""
    import torch

    from asrbench import check, doors, registry
    from asrbench.traffic import Plan

    t_start = T_START if t_start is None else t_start
    mix = cell.mix
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        from qwen3_asr_tpu_torch.ops.build import library

        library()
    door_mod = doors.load(mix["door"])
    ctl = mix.get("control", {}) if control else {}
    plan = Plan(mix, seed)
    door = door_mod.Door(cell.family, cell.config, mix, seed, device,
                         quantize=ctl.get("quantize") if ctl.get("kind") == "program" else None)
    warm(door, plan)
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = door.counters()
    setup_s = time.time() - t_start
    window = drive(door, plan, mix, seconds)
    after = door.counters()
    tr = traced(door, plan, mix) if trace else None
    if on_cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    door.close()
    del door
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    judged = check.sample(window.requests, seed, int(mix["check"]["sample"]))
    numbers = check.judge(cell.family, cell.config, door_mod.kind, plan, judged, seed, device,
                          reference_control=ctl.get("kind") == "reference")
    numbers["failed"] = sum(1 for r in window.requests if not r.ok)
    limits = {"failed": 0, "malformed": 0, "max_gap": mix["check"]["max_gap"],
              "mean_gap": mix["check"]["mean_gap"]}
    correct, compared = check.compare(numbers, limits)
    correct = correct and bool(judged)

    run = Run(cell, door_mod.kind, window, setup_s,
              {k: after[k] - before[k] for k in after}, tr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end) if read_metrics else ():
        value = registry.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(window.requests),
              "failed": numbers["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["compared"] = compared
    info = {"window_s": window.seconds, "judged": len(judged),
            "positions": numbers["positions"], "lateness_s": window.lateness}
    print("run: " + json.dumps(info), file=sys.stderr, flush=True)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    os.environ.update(ENV)
    from asrbench import registry

    cell = registry.cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"asrbench: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = registry.forbidden_modules()
    if found:
        print(f"asrbench: JAX or the JAX package is loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or os.curdir) != _here]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
