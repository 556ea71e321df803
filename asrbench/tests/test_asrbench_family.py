"""A family is new files only. A fixture family
(`fixtures/families/dense_by_layer.py`: Qwen3-ASR's dense shapes, its
weights made a decoder layer at a time, handed to the program and judged
layer by layer), with a configuration, a mix, a cell and a BENCHMARK.json
of its own in a fresh directory, runs a tiny cell on the CPU to `correct`
through the door and the harness as they are; with a decoder layer of the
program's prefill skipped it reads not correct; and no more than one of
its decoder layers is alive at once, in loading or in judging."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch
from conftest import ROOT, tiny_cell

from asrbench import registry
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel
from asrbench.run import run_cell

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "families"
SEED = 2 ** 34 + 21


@pytest.fixture
def fixture_cell(tmp_path, monkeypatch):
    """The cell "dense-short": the fixture family under asr-short-cli's mix
    with int8pc weights, in a benchmark of its own at tmp_path."""
    monkeypatch.setattr(registry, "FAMILIES", FIXTURES)
    cfg = json.loads((ROOT / "asrbench" / "configs" / "qwen3-asr-0.6b.json").read_text())
    cfg.update(name="dense-by-layer", family="dense_by_layer")
    mix = json.loads((ROOT / "asrbench" / "workloads" / "asr-short-cli.json").read_text())
    mix["door_args"]["quantize"] = "int8pc"
    for sub, name, body in (("configs", "dense-by-layer", cfg), ("workloads", "dense-short", mix)):
        (tmp_path / "asrbench" / sub).mkdir(parents=True)
        (tmp_path / "asrbench" / sub / f"{name}.json").write_text(json.dumps(body))
    bench = registry.benchmark(ROOT)
    bench["configs"] = [{"name": "dense-by-layer", "source": cfg["source"],
                         "file": "asrbench/configs/dense-by-layer.json", "reduced": [],
                         "why": "a family made a layer at a time"}]
    bench["workloads"] = [{"name": "dense-short", "config": "dense-by-layer",
                           "traffic": "dense-short", "chips": 1, "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("dense-short", tmp_path)
    monkeypatch.setattr(cell.family, "LIVE", cell.family.Live())
    return cell


def test_a_config_names_its_family(fixture_cell):
    assert fixture_cell.family.__file__ == str(FIXTURES / "dense_by_layer.py")
    assert fixture_cell.family is registry.family({"family": "dense_by_layer"})


def test_a_new_family_runs_correct(fixture_cell):
    r = run_cell(fixture_cell, SEED, 1.5, False, device="cpu", read_metrics=False)
    assert r["correct"], r["compared"]
    live = fixture_cell.family.LIVE
    assert live.most == 1 and live.now == 0


def test_a_skipped_decoder_layer_is_not_correct(fixture_cell, monkeypatch):
    """The program's prefill runs every layer but the first, whose cache
    rows it leaves unwritten."""
    from qwen3_asr_tpu_torch.models import decoder

    fused = decoder._prefill_fused

    def rest(v):
        return v[1:] if torch.is_tensor(v) else {k: x[1:] for k, x in v.items()}

    def skip_first(layers, cfg, h, valid, on_rows):
        return fused({k: rest(v) for k, v in layers.items()},
                     dataclasses.replace(cfg, n_layers=cfg.n_layers - 1), h, valid,
                     lambda l, k, v: on_rows(l + 1, k, v))

    monkeypatch.setattr(decoder, "_prefill_fused", skip_first)
    r = run_cell(fixture_cell, SEED, 1.5, False, device="cpu", read_metrics=False)
    assert not r["correct"], r["compared"]


def test_weights_are_a_function_of_part_and_layer(fixture_cell):
    fam, cfg = fixture_cell.family, fixture_cell.config
    one = fam.make(cfg, SEED, "layer", "cpu", 1)
    again = fam.make(cfg, SEED, "layer", "cpu", 1)
    assert all(torch.equal(one[k], again[k]) for k in one)
    other = fam.make(cfg, SEED, "layer", "cpu", 0)
    assert not torch.equal(one["wq"], other["wq"])
    assert one["wq"].dtype == torch.bfloat16 and one["attn_norm"].dtype == torch.bfloat16


def test_layer_by_layer_is_the_whole_pass(fixture_cell):
    """The fixture's reference, a layer at a time over the jobs, gives the
    logits that the whole decoder in one pass gives on the same weights,
    and its control those of the whole int4 decoder."""
    from asrbench import check
    from asrbench.traffic import Plan

    fam, cfg = fixture_cell.family, fixture_cell.config
    plan = Plan(fixture_cell.mix, SEED)
    reqs = [plan.request(i, k) for i, k in enumerate((0, 3))]
    jobs = []
    for r in reqs:
        toks, off = fam.prompt(cfg, "asr", r)
        seq = toks + [5, 77, 300]
        jobs.append(check.Job(plan.pcm(r), seq, off, slice(len(toks) - 1, len(seq))))
    got = fam.reference(cfg, SEED, "cpu", jobs, control=True)
    assert fam.LIVE.most == 1
    L = cfg["text"]["decoder_layers"]
    layers = [fam.make(cfg, SEED, "layer", "cpu", l, torch.float32) for l in range(L)]
    dec = dict(rmodel.f32(fam.make(cfg, SEED, "top", "cpu")),
               layers={k: torch.stack([lw[k] for lw in layers]) for k in layers[0]})
    int4 = rmodel.quantize_int4(dec)
    enc = rmodel.f32(fam.make(cfg, SEED, "encoder", "cpu"))
    for job, (logits, low) in zip(jobs, got):
        audio = rmodel.encode(enc, cfg, rmel.log_mel(job.pcm, "cpu"))
        for d, have in ((dec, logits), (int4, low)):
            h = rmodel.decode(d, cfg, job.tokens, audio, job.audio_offset)
            assert torch.equal(have, rmodel.lm_logits(d, h[job.rows]))
        assert not torch.equal(logits, low)
