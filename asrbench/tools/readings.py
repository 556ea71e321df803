"""The readings a cell's limits are set from: the numbers `correct`
compares, for the program as configured and for its control, over many
seeds in one process (the kernel library and the warm-up paid once).

    python3 asrbench/tools/readings.py --workload <cell> --seconds <s>
        --seeds <n> [<n> ...] [--control] [--fault <name>]
        [--door-arg <key>=<value>] [--out <file.jsonl>]

Each seed is a whole run of the cell (its own weights, traffic, window and
judged sample) at the cell's own sizes, without the metrics; one JSON line
a seed: the seed, whether it was the control, the fault planted and the
door arguments changed, and each compared number. `--fault` plants one of
`asrbench/faults.py`'s faults in the program; `--door-arg` runs the
program with one of the mix's door arguments changed (as `kv_cache=int8`),
to read whether the comparison separates it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--door-arg", action="append", default=[])
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    from asrbench import registry
    from asrbench.run import CACHES, run_cell

    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    cell = registry.cell(ROOT, args.workload)
    changed = dict(a.split("=", 1) for a in args.door_arg)
    cell.mix = dict(cell.mix, door_args={**cell.mix["door_args"], **changed})
    if args.fault:
        from asrbench.faults import FAULTS

        FAULTS[args.fault]()
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.time()
            r = run_cell(cell, seed, args.seconds, False, control=args.control,
                         t_start=t0, read_metrics=False)
            line = {"workload": args.workload, "seed": seed, "control": args.control,
                    "fault": args.fault, "door_args": changed,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "compared": {k: v["value"] for k, v in r["compared"].items()},
                    "seconds": time.time() - t0}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
