"""Finds everything by name: `BENCHMARK.json` at the root of the checkout
names the cells; a cell names its configuration (the config entry's
`file`) and its traffic mix (`asrbench/workloads/<traffic>.json`); a
configuration names its model family (`"family"`, `qwen3_asr` where it
names none), whose module is `asrbench/families/<family>.py`; a metric is
read by `asrbench/metrics/<name>.py`. Adding a configuration, a mix, a
cell, a metric or a family is adding its file and its entry: nothing here
changes.

A family module supplies everything that depends on the model's layers
(`families/qwen3_asr.py` is the one the benchmark has):

- `port_config(cfg)`: the program's config objects for the configuration;
- `load(program, cfg, seed, device)`: makes the weights from the seed on
  the device and hands them to the program a door built (`Qwen3ASR`,
  `ForcedAligner`). The weights are a pure function of (configuration,
  seed, part, layer), so a family whose whole tree would not fit beside
  the program's copy makes and hands over one decoder layer at a time:
  at peak the harness holds one layer beyond what the program keeps.
  Handed over so, the layers go in as the program's int8pc leaves, and
  the cell's mix runs the door with `quantize` "int8pc": under "auto" the
  port takes leaves already int8 for a GGUF's and builds no int8 decode
  pack (`tests/fixtures/families/dense_by_layer.py` shows the path);
- `prompt(cfg, kind, req)`: (tokens, audio_offset), the prompt the program
  builds for a request: an ASR request's before its served tokens, an
  alignment's whole (the aligner gives a class a row);
- `reference(cfg, seed, device, jobs, control)`: the plain reference's
  logits at the rows of every judged request at once (`check.Job`), with
  the control's beside them (None without `control`). The weights are
  made again from the seed; taking the jobs together lets a family run
  them layer by layer with one layer's float32 weights alive;
- `request_ops(cfg, kind, req)`, `decode_positions(cfg, req)` and
  `step_work(cfg, positions, kv)`: the operations of a request, the cache
  positions of a transcription's decode steps, and the (bytes, operations)
  of one decode step of rows at `positions`, for `layers.py`'s `mfu` and
  rooflines;
- `tiny(cfg)`: the configuration at test widths, for the CPU tests.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FAMILIES = HERE / "families"
DEFAULT_FAMILY = "qwen3_asr"
FAMILY_API = ("port_config", "load", "prompt", "reference", "request_ops", "decode_positions",
              "step_work", "tiny")
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_asr_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # the configuration file
    mix: dict            # the traffic mix file
    end_to_end: list     # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list      # ... and its per-layer metrics
    family: object       # the configuration's family module

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
                [m for m in bench["per_layer"] if _applies(m, name)],
                family(config))


def family(config: dict):
    """The family module of a configuration: FAMILIES/<family>.py, loaded
    once a path."""
    name = config.get("family", DEFAULT_FAMILY)
    if not name.isidentifier():
        raise ValueError(f"bad family name {name!r}")
    return _module(FAMILIES / f"{name}.py")


@functools.cache
def _module(path: Path):
    if not path.is_file():
        raise FileNotFoundError(f"no family module at {path}")
    spec = importlib.util.spec_from_file_location(f"asrbench_family_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [n for n in FAMILY_API if not callable(getattr(mod, n, None))]
    if missing:
        raise AttributeError(f"family module {path} lacks {', '.join(missing)}")
    return mod


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
