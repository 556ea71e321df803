"""The benchmark finds every configuration, cell and metric by name, a new
cell is a new file and an entry, and BENCHMARK.json keeps to the
contract's shape."""

from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT

from asrbench import doors, registry

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = registry.cell(ROOT, name)
    assert cell.config["name"] == cell.entry["config"]
    assert doors.load(cell.mix["door"]).kind in ("asr", "align")
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    reported = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in reported for m in cell.per_layer)
    assert all(callable(getattr(cell.family, n)) for n in registry.FAMILY_API)


@pytest.mark.parametrize("config,found", [
    ({}, "qwen3_asr"), ({"family": "qwen3_asr"}, "qwen3_asr"),
    ({"family": "no_such_family"}, FileNotFoundError), ({"family": "../run"}, ValueError)])
def test_a_family_is_found_by_name(config, found):
    """A configuration that names no family is qwen3_asr's."""
    if isinstance(found, str):
        assert registry.family(config).__name__ == f"asrbench_family_{found}"
    else:
        with pytest.raises(found):
            registry.family(config)


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(registry.reader(name).read)


def test_a_new_cell_is_a_new_file(tmp_path):
    """A cell added to BENCHMARK.json with its mix file resolves, with no
    other file touched."""
    shutil.copytree(ROOT / "asrbench" / "configs", tmp_path / "asrbench" / "configs")
    shutil.copytree(ROOT / "asrbench" / "workloads", tmp_path / "asrbench" / "workloads")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "asr-mid-cli", "config": "qwen3-asr-0.6b",
                               "traffic": "asr-mid-cli", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "asrbench" / "workloads" / "asr-short-cli.json").read_text())
    mix["audio_s"] = [15, 30]
    (tmp_path / "asrbench" / "workloads" / "asr-mid-cli.json").write_text(json.dumps(mix))
    cell = registry.cell(tmp_path, "asr-mid-cli")
    assert cell.mix["audio_s"] == [15, 30]
    assert [m["name"] for m in cell.end_to_end] == [m["name"] for m in BENCH["end_to_end"]]
    with pytest.raises(KeyError):
        registry.cell(tmp_path, "no-such-cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)
    assert len(set(METRICS)) == len(METRICS)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith(tuple(BENCH["paths"])) and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_family_must_supply_the_whole_interface(tmp_path, monkeypatch):
    (tmp_path / "half.py").write_text("def port_config(cfg):\n    return None\n")
    monkeypatch.setattr(registry, "FAMILIES", tmp_path)
    with pytest.raises(AttributeError, match="load, prompt, reference"):
        registry.family({"family": "half"})
