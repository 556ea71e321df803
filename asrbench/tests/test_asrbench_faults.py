"""Whole runs at a tiny size on the CPU (the program's plain paths), with
the chip's look skipped: sound, each cell comes out correct; with its timed
path broken underneath in each way the cell can break, `correct` comes out
false: in the decode (a token altered, a step that leaves its state, half a
batch left out), in the aligner's pass and classes, and in the encoder (a
layer skipped). The mel frames shifted (`asrbench/faults.py`) change too
little in a model this small to be seen; `test_asrbench_control.py` holds
that fault at each cell's own size on the card. The exchange between chips does not exist
here: every cell runs on one chip."""

from __future__ import annotations

import numpy as np
import pytest
from conftest import tiny_cell

from asrbench.faults import FAULTS
from asrbench.run import run_cell

SEED = 2 ** 34 + 9


def _run(cell: str) -> dict:
    return run_cell(tiny_cell(cell), SEED, 1.5, False, device="cpu", read_metrics=False)


def _altered(out: np.ndarray) -> np.ndarray:
    """A token altered where it is produced: the second of each row + 1."""
    out = np.array(out)
    out[..., 1] = (out[..., 1] + 1) % 512
    return out


@pytest.mark.parametrize("cell", ["asr-longform-cli", "asr-short-cli", "align-longform-cli",
                                  "asr-server-poisson"])
def test_sound_runs_are_correct(cell):
    r = _run(cell)
    assert r["correct"], r["compared"]
    assert r["compared"]["max_gap"]["value"] < r["compared"]["max_gap"]["limit"]


@pytest.mark.parametrize("cell", ["asr-short-cli", "asr-server-poisson"])
def test_a_token_altered(cell, monkeypatch):
    from qwen3_asr_tpu_torch.models import e2e, generate
    from qwen3_asr_tpu_torch.parallel import mesh

    def wrap(fn):
        def broken(*a, **kw):
            out, kept = fn(*a, **kw)
            return _altered(out), kept
        return broken

    monkeypatch.setattr(e2e, "generate_greedy", wrap(e2e.generate_greedy))
    monkeypatch.setattr(generate, "generate_greedy", wrap(generate.generate_greedy))
    monkeypatch.setattr(mesh, "batched_transcribe_step", wrap(mesh.batched_transcribe_step))
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["asr-short-cli", "asr-server-poisson"])
def test_a_step_that_leaves_its_state(cell, monkeypatch):
    from qwen3_asr_tpu_torch.models import generate

    def runner(*a, **kw):
        def run(out, i, pos):
            out[i:i + 1] = out[i - 1:i]
        return run

    loop = generate._batch_loop
    monkeypatch.setattr(generate, "_step_runner", runner)
    monkeypatch.setattr(generate, "_batch_loop",
                        lambda step, first, *a: loop(lambda cur, i: cur, first, *a))
    assert not _run(cell)["correct"]


def test_half_the_batch_left_out(monkeypatch):
    """The server's batched step computes the first half of its rows and
    gives the others those rows' tokens."""
    from qwen3_asr_tpu_torch.parallel import mesh

    step = mesh.batched_transcribe_step

    def half(dec, cfg, tokens, n_prompt, audio, n_audio, *rest, **kw):
        h = max(1, tokens.shape[0] // 2)
        out, kept = step(dec, cfg, tokens[:h], n_prompt[:h], audio[:h], n_audio[:h], *rest, **kw)
        rows = [b % h for b in range(tokens.shape[0])]
        return out[rows], kept[rows]

    monkeypatch.setattr(mesh, "batched_transcribe_step", half)
    assert not _run("asr-server-poisson")["correct"]


def test_an_alignment_class_altered(monkeypatch):
    from qwen3_asr_tpu_torch.models import e2e

    fused = e2e.align_fused

    def broken(params, cfg, samples, filters_t, input_tokens, audio_offset=1):
        pred = fused(params, cfg, samples, filters_t, input_tokens, audio_offset).copy()
        ts = [i for i, t in enumerate(input_tokens) if t == cfg.timestamp_token_id]
        pred[ts[0]] = (pred[ts[0]] + 1) % cfg.decoder.classify_num
        return pred

    monkeypatch.setattr(e2e, "align_fused", broken)
    assert not _run("align-longform-cli")["correct"]


def test_an_alignment_pass_that_leaves_its_state(monkeypatch):
    """The aligner's causal pass returns its input rows."""
    from qwen3_asr_tpu_torch.models import generate

    monkeypatch.setattr(generate, "_prefill_layers", lambda dec, cfg, h, *a: h)
    assert not _run("align-longform-cli")["correct"]


@pytest.mark.parametrize("cell", ["asr-longform-cli", "asr-short-cli", "align-longform-cli",
                                  "asr-server-poisson"])
def test_an_encoder_layer_skipped(cell, monkeypatch):
    FAULTS["encoder_layer_skipped"](monkeypatch.setattr)
    assert not _run(cell)["correct"]
