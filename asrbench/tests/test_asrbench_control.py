"""Each cell's control, at the cell's own size on the card: the program's
lower-precision path (int4 decode weights) or the reference at int4 in the
program's place must come out not correct, on three seeds; and so must the
program with its mel frames shifted (`asrbench/faults.py`), which a model
of test size is too small to show. Skips without an sm_90 card; run on
the chip with

    python3 -m pytest -q -m cuda asrbench/tests/test_asrbench_control.py
"""

from __future__ import annotations

import time

import pytest
from conftest import ROOT

from asrbench import registry
from asrbench.faults import FAULTS
from asrbench.run import run_cell

# window seconds: long enough to finish the mix's longest requests and to
# judge as many as a run does
SECONDS = {"asr-longform-cli": 18.0, "align-longform-cli": 8.0, "asr-short-cli": 6.0,
           "asr-server-poisson": 8.0}
CELLS = [w["name"] for w in registry.benchmark(ROOT)["workloads"]]


def seconds(cell) -> float:
    """The cell's window above, or a fifth of its mix's longest audio and
    at least 6 s (near the table's windows of the closed loops: 18.4 s for
    longform's 92 s, 6 s for short's 15)."""
    if cell.name in SECONDS:
        return SECONDS[cell.name]
    return max(6.0, cell.mix["audio_s"][1] / 5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda):
    cell = registry.cell(ROOT, name)
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        r = run_cell(cell, seed, seconds(cell), False, control=True, t_start=time.time(),
                     read_metrics=False)
        assert not r["correct"], (seed, r["compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault,name", [("mel_frames_shifted", n) for n in CELLS])
def test_front_end_fault_is_not_correct(fault, name, cuda, monkeypatch):
    cell = registry.cell(ROOT, name)
    FAULTS[fault](monkeypatch.setattr)
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        r = run_cell(cell, seed, seconds(cell), False, t_start=time.time(), read_metrics=False)
        assert not r["correct"], (seed, r["compared"])


@pytest.mark.parametrize("name,mix,want", [
    ("asr-longform-cli", {}, 18.0),
    ("asr-mid-cli", {"audio_s": [15, 60]}, 12.0),
    ("asr-tiny-cli", {"audio_s": [1, 4]}, 6.0)])
def test_a_new_cell_takes_its_window_from_its_mix(name, mix, want):
    """A cell the table above lacks runs with its mix's window, not a KeyError."""
    cell = registry.cell(ROOT, "asr-short-cli")
    cell.name, cell.mix = name, dict(cell.mix, **mix)
    assert seconds(cell) == want
