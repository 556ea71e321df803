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


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, cuda):
    cell = registry.cell(ROOT, name)
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        r = run_cell(cell, seed, SECONDS[name], False, control=True, t_start=time.time(),
                     read_metrics=False)
        assert not r["correct"], (seed, r["compared"])


@pytest.mark.cuda
@pytest.mark.parametrize("fault,name", [("mel_frames_shifted", n) for n in CELLS])
def test_front_end_fault_is_not_correct(fault, name, cuda, monkeypatch):
    cell = registry.cell(ROOT, name)
    FAULTS[fault](monkeypatch.setattr)
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        r = run_cell(cell, seed, SECONDS[name], False, t_start=time.time(), read_metrics=False)
        assert not r["correct"], (seed, r["compared"])
