"""The `qwen3_asr` family reads what the harness read before configurations
named a family (commit 0083258): the same weights for a seed, the same
numbers compared in a run and by the judge, the same work counts and the
same per-layer readings of a trace. Every value below was computed with
that commit's harness on the CPU at the tiny size (`family.tiny`); a
change here moves what the benchmark reads."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_cell, tiny_config

from asrbench import check, registry
from asrbench import run as run_module
from asrbench.faults import FAULTS
from asrbench.traffic import Plan, loops

SEEDS = (2 ** 34 + 9, 3_170_001_801)
CONFIGS = ("qwen3-asr-0.6b", "qwen3-forced-aligner-0.6b")
CELLS = ("asr-longform-cli", "align-longform-cli", "asr-short-cli", "asr-server-poisson")

# sha256 (first 32 hex digits) over every leaf of `weights.make`: its path,
# dtype, shape and bytes, in sorted order
WEIGHTS = {
    ("qwen3-asr-0.6b", 17179869193): "dc16bd6c06cc167a8d2623107b202b26",
    ("qwen3-asr-0.6b", 3170001801): "d4820f1e6da9fc57f25dd371f0afb02e",
    ("qwen3-forced-aligner-0.6b", 17179869193): "2377d872449d75c284e48dd5adec49f1",
    ("qwen3-forced-aligner-0.6b", 3170001801): "54843a958e276ed8e304cdd84445499e",
}

# (max_gap, mean_gap) of `run_cell` at the tiny size with a window of four
# requests one after another (failed and malformed 0): sound, and with the
# encoder's first layer skipped
RUNS = {
    ("asr-longform-cli", 17179869193): (0.0, 0.0),
    ("asr-longform-cli", 3170001801): (0.0, 0.0),
    ("align-longform-cli", 17179869193): (0.09056806564331055, 0.009164373079935709),
    ("align-longform-cli", 3170001801): (0.0, 0.0),
    ("asr-short-cli", 17179869193): (0.0, 0.0),
    ("asr-short-cli", 3170001801): (0.0, 0.0),
    ("asr-server-poisson", 17179869193): (0.0, 0.0),
    ("asr-server-poisson", 3170001801): (0.0, 0.0),
}
FAULT_RUNS = {
    ("asr-longform-cli", 17179869193): (7.893362998962402, 5.5331573486328125),
    ("asr-longform-cli", 3170001801): (7.796226978302002, 1.1718822055392795),
    ("align-longform-cli", 17179869193): (2.713200807571411, 1.4785128169589572),
    ("align-longform-cli", 3170001801): (11.17962646484375, 4.740559154086643),
    ("asr-short-cli", 17179869193): (7.893362998962402, 5.5331573486328125),
    ("asr-short-cli", 3170001801): (7.796226978302002, 1.1718822055392795),
    ("asr-server-poisson", 17179869193): (7.893362998962402, 5.731549421946208),
    ("asr-server-poisson", 3170001801): (7.796226978302002, 0.9017136891682943),
}

# (max_gap, mean_gap, malformed, positions) of `check.judge` over three
# requests of seeded random outputs and one of the wrong length, as the
# program's outputs and with the reference's int4 control
JUDGE = {
    ("asr-short-cli", 17179869193, False): (11.749593734741211, 7.658870273166233, 1, 18),
    ("asr-short-cli", 17179869193, True): (3.9329464435577393, 1.1730745898352728, 1, 18),
    ("asr-short-cli", 3170001801, False): (12.85749626159668, 7.301216973198785, 1, 18),
    ("asr-short-cli", 3170001801, True): (2.202085494995117, 0.542235533396403, 1, 18),
    ("align-longform-cli", 17179869193, False): (8.308320999145508, 4.16801389058431, 1, 18),
    ("align-longform-cli", 17179869193, True): (2.099059820175171, 0.4865492052502102, 1, 18),
    ("align-longform-cli", 3170001801, False): (9.501937866210938, 5.548244900173611, 1, 18),
    ("align-longform-cli", 3170001801, True): (2.270766496658325, 1.0923834906684027, 1, 18),
}

# sha256 (first 32 hex digits) of every request of each mix (its 48 lengths
# at seed 1, full-size configurations): the request's operations and, for
# a transcription, the bytes and operations of its decode steps one row at
# a time (summed) and of its first two steps as one batch
WORK = "eda4c0da2f55cd970bd291e28acd2f87"

# mfu, the idle share and the two decode rooflines of test_asrbench_spans's
# synthetic trace
SPANS = {"mfu": 0.39812237330637, "idle": 53.33333333333332, "k1": 4.16342763719862,
         "k3": 7.81424443496801}


def _config(name: str) -> dict:
    return json.loads((ROOT / "asrbench" / "configs" / f"{name}.json").read_text())


def _digest(tree: dict) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], path + (k,))
                continue
            a = t[k].detach().cpu().contiguous()
            h.update(("/".join(path + (k,)) + str(a.dtype) + str(tuple(a.shape))).encode())
            h.update(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
                     .numpy().tobytes())
    walk(tree, ())
    return h.hexdigest()[:32]


@pytest.mark.parametrize("name,seed", list(WEIGHTS))
def test_weights_are_bit_identical(name, seed):
    from asrbench import weights

    assert _digest(weights.make(tiny_config(_config(name)), seed, "cpu")) == WEIGHTS[name, seed]


def _four_requests(monkeypatch):
    """A window of exactly four requests, one after another, whatever the
    clock reads: the same sample on every run."""
    monkeypatch.setattr(run_module, "drive",
                        lambda door, plan, mix, seconds: loops.closed(door, plan, None, count=4))


@pytest.mark.parametrize("cell,seed", list(RUNS))
def test_a_run_compares_the_same_numbers(cell, seed, monkeypatch):
    _four_requests(monkeypatch)
    r = run_module.run_cell(tiny_cell(cell), seed, 0.0, False, device="cpu", read_metrics=False)
    got = {k: v["value"] for k, v in r["compared"].items()}
    assert got == {"failed": 0, "malformed": 0, "max_gap": RUNS[cell, seed][0],
                   "mean_gap": RUNS[cell, seed][1]}


@pytest.mark.parametrize("cell,seed", list(FAULT_RUNS))
def test_a_faulty_run_compares_the_same_numbers(cell, seed, monkeypatch):
    _four_requests(monkeypatch)
    FAULTS["encoder_layer_skipped"](monkeypatch.setattr)
    r = run_module.run_cell(tiny_cell(cell), seed, 0.0, False, device="cpu", read_metrics=False)
    got = {k: v["value"] for k, v in r["compared"].items()}
    assert got == {"failed": 0, "malformed": 0, "max_gap": FAULT_RUNS[cell, seed][0],
                   "mean_gap": FAULT_RUNS[cell, seed][1]}
    assert not r["correct"]


def _fabricated(cell, kind: str, seed: int):
    """Three requests with seeded random outputs of the right length, then
    one of the wrong length."""
    cfg, plan = cell.config, Plan(cell.mix, seed)
    rng = np.random.default_rng(seed)
    reqs = []
    for i, k in enumerate((0, 3, 1)):
        r = plan.request(i, k)
        if kind == "asr":
            n, top = r.max_tokens, cfg["vocab_size"]
        else:
            n, top = len(cell.family.prompt(cfg, kind, r)[0]), cfg["classify_num"]
        r.output, r.t_done = [int(x) for x in rng.integers(0, top, n)], 1.0
        reqs.append(r)
    bad = plan.request(9, 2)
    bad.output, bad.t_done = [1, 2], 1.0
    return plan, reqs + [bad]


@pytest.mark.parametrize("cell,seed,control", list(JUDGE))
def test_the_judge_reads_the_same(cell, seed, control):
    c = tiny_cell(cell)
    kind = "asr" if cell.startswith("asr") else "align"
    plan, reqs = _fabricated(c, kind, seed)
    got = check.judge(c.family, c.config, kind, plan, reqs, seed, "cpu", reference_control=control)
    assert (got["max_gap"], got["mean_gap"], got["malformed"], got["positions"]) == \
        JUDGE[cell, seed, control]


def test_work_counts_the_same():
    rows = {}
    for name in CELLS:
        cell = registry.cell(ROOT, name)
        fam, cfg = cell.family, cell.config
        kind = "align" if "align" in name else "asr"
        kv = cell.mix["door_args"].get("kv_cache", "bf16")
        plan = Plan(cell.mix, 1)
        rows[name] = []
        for k in range(cell.mix["sizes"]):
            r = plan.request(k, k)
            row = [fam.request_ops(cfg, kind, r)]
            if kind == "asr":
                pos = fam.decode_positions(cfg, r)
                steps = [fam.step_work(cfg, [p], kv) for p in pos]
                row += [sum(b for b, _ in steps), sum(o for _, o in steps)]
                row += list(fam.step_work(cfg, pos[:2], kv))
            rows[name].append(row)
    assert hashlib.sha256(json.dumps(rows).encode()).hexdigest()[:32] == WORK


def test_layers_read_the_same_trace():
    import test_asrbench_spans as ts

    from asrbench import layers

    run = ts.run_of(ts.trace(True), _config("qwen3-asr-0.6b"))
    got = {"mfu": layers.mfu(run), "idle": layers.idle_share(run),
           "k1": layers.decode_roofline(run, "k1"), "k3": layers.decode_roofline(run, "k3")}
    assert got == SPANS
