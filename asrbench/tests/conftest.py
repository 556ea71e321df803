"""Shared pieces of the benchmark's own tests: the checkout on sys.path, a
cell cut to a tiny size for runs on the CPU, and the `cuda` fixture."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_config(cfg: dict) -> dict:
    """The configuration at its family's test widths (`family.tiny`)."""
    from asrbench import registry

    return registry.family(cfg).tiny(cfg)


# The widest logit gap of sound tiny runs: 0.224 over 12 runs of the three
# kinds of cell (4 seeds, a 1.5 s window each); a planted fault reads
# several units.
TINY_MAX_GAP = 1.0
TINY_MEAN_GAP = 0.1


def tiny_cell(name: str, root: Path = ROOT):
    """The cell `name` of the benchmark at `root` with a tiny configuration
    and short requests (2-4 s audio, a few tokens), for CPU runs, judged
    against TINY_MAX_GAP."""
    from asrbench import registry

    cell = registry.cell(root, name)
    cell.config = cell.family.tiny(cell.config)
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
