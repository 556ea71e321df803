"""The highest Poisson rate a serving cell's program sustains: one model,
one warm-up, then an open-loop window at each rate in turn.

    python3 asrbench/tools/sweep.py --workload <cell> --seed <n> --seconds <s>
        --rates <r> [<r> ...]

A rate is sustained when every request comes back and the backlog does not
grow: the last quarter's median latency stays within 1.5x the first
quarter's. Per rate one JSON line: offered and completed requests per
second, audio seconds per second, the latency percentiles, the quarters'
medians and the generator's lateness.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from asrbench import doors, registry
    from asrbench.run import CACHES, warm
    from asrbench.traffic import Plan, loops

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    from qwen3_asr_tpu_torch.ops.build import library

    library()
    cell = registry.cell(ROOT, args.workload)
    door = doors.load(cell.mix["door"]).Door(cell.family, cell.config, cell.mix, args.seed,
                                             "cuda")
    warm(door, Plan(cell.mix, args.seed))
    torch.cuda.synchronize()
    for rate in args.rates:
        mix = dict(cell.mix, rate_per_s=rate)
        plan = Plan(mix, args.seed)
        t0 = time.time()
        win = loops.open_loop(door, plan, plan.schedule(args.seconds))
        lat = sorted(r.latency for r in win.requests)
        q = len(win.requests) // 4
        by_due = sorted(win.requests, key=lambda r: r.t_due)
        first = statistics.median(r.latency for r in by_due[:q])
        last = statistics.median(r.latency for r in by_due[-q:])
        done = win.done
        line = {"rate": rate, "sent": len(win.requests), "done": len(done),
                "done_per_s": len(done) / win.seconds,
                "audio_s_per_s": sum(r.seconds for r in done) / win.seconds,
                "p50_ms": 1e3 * lat[len(lat) // 2], "p90_ms": 1e3 * lat[int(0.9 * len(lat))],
                "first_quarter_ms": 1e3 * first, "last_quarter_ms": 1e3 * last,
                "sustained": len(done) == len(win.requests) and last <= 1.5 * first,
                "lateness_s": win.lateness, "wall_s": time.time() - t0,
                "batches": len(door.batches)}
        print(json.dumps(line), flush=True)
    door.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
