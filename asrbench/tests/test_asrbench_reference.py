"""The benchmark's plain reference agrees, at a tiny size on the CPU, with
the repository's float64 oracle (`tests/oracles/torch_ref.py`) and with
the port's float64 log-mel."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_config

from asrbench import registry, weights
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel
from asrbench.reference import prompt as rprompt
from asrbench.traffic import Plan

sys.path.insert(0, str(ROOT / "tests"))
from oracles import torch_ref  # noqa: E402

CONFIGS = ("qwen3-asr-0.6b", "qwen3-forced-aligner-0.6b")
REL = 2e-4   # float32 against float64 through 2 + 2 layers


def _setup(name: str, seconds: float = 3.3):
    cfg = tiny_config(json.loads((ROOT / "asrbench" / "configs" / f"{name}.json").read_text()))
    tree = rmodel.f32(weights.make(cfg, 2 ** 35 + 1, "cpu"))
    plan = Plan({"audio_s": [seconds - 0.1, seconds + 0.1], "sizes": 1}, 4)
    pcm = plan.pcm(plan.request(0, 0))
    return cfg, tree, pcm


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.double().numpy() for k, v in tree.items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_log_mel_matches_the_float64_mel():
    from qwen3_asr_tpu_torch.audio.mel import log_mel_spectrogram_ref

    _, _, pcm = _setup(CONFIGS[0])
    got = rmel.log_mel(pcm, "cpu").numpy()
    want = log_mel_spectrogram_ref(pcm.astype(np.float32) / 32768.0)
    assert got.shape == want.shape == (128, len(pcm) // 160)
    assert np.abs(got - want).max() < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_matches_the_oracle(name):
    cfg, tree, pcm = _setup(name)
    mel = rmel.log_mel(pcm, "cpu")
    got = rmodel.encode(tree["encoder"], cfg, mel)
    ecfg = registry.family(cfg).port_config(cfg).encoder
    want = torch_ref.encoder_forward(_np(tree["encoder"]), ecfg, mel.numpy())
    assert got.shape[0] == rprompt.audio_rows(mel.shape[1]) == want.shape[0]
    assert _rel(got, want) < REL


@pytest.mark.parametrize("name", CONFIGS)
def test_decoder_and_heads_match_the_oracle(name):
    cfg, tree, pcm = _setup(name)
    audio = rmodel.encode(tree["encoder"], cfg, rmel.log_mel(pcm, "cpu"))
    if cfg.get("classify_num"):
        toks, off = rprompt.align_prompt(cfg, audio.shape[0], rprompt.align_words(3))
    else:
        toks, off = rprompt.asr_prompt(cfg, audio.shape[0])
        toks = toks + [5, 77, 300]
    dec = tree["decoder"]
    h = rmodel.decode(dec, cfg, toks, audio, off)
    dcfg = registry.family(cfg).port_config(cfg).decoder
    h_ref = torch_ref.decoder_forward(_np(dec), dcfg, np.asarray(toks), audio.double().numpy(), off)
    if cfg.get("classify_num"):
        got = rmodel.classify_logits(dec, h)
        want = torch_ref.classify_logits(_np(dec), dcfg, h_ref)
    else:
        got = rmodel.lm_logits(dec, h)
        want = torch_ref.lm_logits(_np(dec), dcfg, h_ref)
    assert _rel(got, want) < REL


def test_int4_control_rounds_to_sixteen_levels():
    cfg, tree, _ = _setup(CONFIGS[0])
    low = rmodel.quantize_int4(tree["decoder"])
    w, q = tree["decoder"]["layers"]["wq"], low["layers"]["wq"]
    s = w.abs().amax(dim=-2, keepdim=True) / 7.0
    codes = q / s
    assert torch.allclose(codes, codes.round(), atol=1e-4) and codes.abs().max() <= 7.0001
    assert 0.01 < _rel(q, w) < 0.3


@pytest.mark.parametrize("extra", (-1, 1))
def test_prompt_and_audio_rows_must_agree(extra):
    """A prompt that holds one audio row more or less than the tower gave
    is refused, not spliced over in part."""
    cfg, tree, pcm = _setup(CONFIGS[0])
    audio = rmodel.encode(tree["encoder"], cfg, rmel.log_mel(pcm, "cpu"))
    toks, off = rprompt.asr_prompt(cfg, audio.shape[0] + extra)
    with pytest.raises(ValueError, match="audio rows"):
        rmodel.embed(tree["decoder"], toks, audio, off)
