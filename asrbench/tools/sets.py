"""Sets of whole runs of one cell, each a process of its own as the
benchmark's command runs it, and the spread of every metric per set.

    python3 asrbench/tools/sets.py --workload <cell> --seeds <n> [<n> ...]
        [--sets 2] [--trace 0] [--seconds <s>] [--out <file.jsonl>]

Every set runs the same seeds in order; --seconds defaults to
BENCHMARK.json's run_seconds. Each run's result line goes to --out with
its set, seed, exit code and wall seconds; then per set and metric the
median and the spread (first to third quartile over the median).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from asrbench.stats import spread

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    runs = []
    for s in range(args.sets):
        for seed in args.seeds:
            cmd = bench["command"] + ["--workload", args.workload, "--seed", str(seed),
                                      "--seconds", f"{seconds:g}", "--trace", str(args.trace)]
            t0 = time.time()
            out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1500)
            line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
            try:
                result = json.loads(line)
            except json.JSONDecodeError:
                result = None
            rec = {"workload": args.workload, "set": s, "seed": seed, "rc": out.returncode,
                   "wall_s": time.time() - t0, "result": result}
            if result is None:
                rec["stderr"] = out.stderr[-3000:]
            runs.append(rec)
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    for s in range(args.sets):
        rows = [r["result"] for r in runs if r["set"] == s and r["result"]]
        names = sorted({k for r in rows for k in r["metrics"]})
        for name in names:
            vals = [r["metrics"][name]["value"] for r in rows if name in r["metrics"]]
            med = sorted(vals)[len(vals) // 2]
            sp = spread(vals) if len(vals) >= 2 else float("nan")
            print(f"set {s} {name}: n {len(vals)} median {med} spread {sp:.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
