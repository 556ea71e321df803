"""Finds everything by name: `BENCHMARK.json` at the root of the checkout
names the cells; a cell names its configuration (the config entry's
`file`) and its traffic mix (`asrbench/workloads/<traffic>.json`); a metric
is read by `asrbench/metrics/<name>.py`. Adding a configuration, a mix, a
cell or a metric is adding its file and its entry: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_asr_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # the configuration file
    mix: dict            # the traffic mix file
    end_to_end: list     # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list      # ... and its per-layer metrics

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    """The cell `name` with its configuration, mix and metrics."""
    root = Path(root)
    bench = bench or benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    mix = json.loads((root / "asrbench" / "workloads" / f"{entry['traffic']}.json").read_text())
    return Cell(name, entry, config, mix,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(name: str):
    """The module asrbench/metrics/<name>.py (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"asrbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})
