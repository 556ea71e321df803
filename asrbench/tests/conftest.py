"""Shared pieces of the benchmark's own tests: the checkout on sys.path, a
cell cut to a tiny size for runs on the CPU, and the `cuda` fixture."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_config(cfg: dict) -> dict:
    """The configuration at test widths: 2 + 2 layers, hidden 64, a 512-entry
    vocabulary (the special ids at its top). The weights are N(0, 0.3^2):
    at 0.02 or 0.08 a model this small says one token whatever it hears,
    and no check of its outputs could see a step or a row go missing."""
    c = copy.deepcopy(cfg)
    c["audio"].update(encoder_layers=2, d_model=32, attention_heads=4, ffn_dim=64,
                      conv_channels=8, output_dim=64)
    c["text"].update(decoder_layers=2, hidden_size=64, attention_heads=4,
                     num_key_value_heads=2, head_dim=16, intermediate_size=96)
    V = 512
    c["vocab_size"] = V
    c["tokens"] = {k: V - 1 - i for i, k in enumerate(sorted(c["tokens"]))}
    c["tokens"]["im_end"] = c["tokens"]["eos"]
    if c.get("classify_num"):
        c["classify_num"] = 50
    c["init"] = {"std": 0.3, "conv1_std": 0.1}
    return c


# The widest logit gap of sound tiny runs: 0.224 over 12 runs of the three
# kinds of cell (4 seeds, a 1.5 s window each); a planted fault reads
# several units.
TINY_MAX_GAP = 1.0
TINY_MEAN_GAP = 0.1


def tiny_cell(name: str):
    """The benchmark's cell `name` with a tiny configuration and short
    requests (2-4 s audio, a few tokens), for CPU runs, judged against
    TINY_MAX_GAP."""
    from asrbench import registry

    cell = registry.cell(ROOT, name)
    cell.config = tiny_config(cell.config)
    mix = dict(cell.mix, audio_s=[2, 4], sizes=4,
               trace_requests=6 if cell.mix["loop"] != "closed" else 2)
    if "rate_per_s" in mix:
        mix["rate_per_s"] = 20.0
    if "max_tokens" in mix:
        mix["max_tokens"] = 8
    if "tokens_per_audio_s" in mix:
        mix["tokens_per_audio_s"] = 2.0
    if "words_per_audio_s" in mix:
        mix["words_per_audio_s"] = 1.0
    mix["check"] = dict(mix["check"], sample=3, max_gap=TINY_MAX_GAP, mean_gap=TINY_MEAN_GAP)
    cell.mix = mix
    return cell


@pytest.fixture
def cuda():
    """Skips the test unless an sm_90 CUDA device is present."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.get_device_capability(0) == (9, 0)):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda")
