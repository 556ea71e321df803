"""Audio-frame arithmetic shared with the forced aligner's post-processing.

The port's own copy of `get_feat_extract_output_lengths` from
qwen3_asr_tpu/text/timestamps.py (the aligner's timestamp repair is not
ported).
"""

from __future__ import annotations


def get_feat_extract_output_lengths(input_lengths: int) -> int:
    """audio_pad count (encoder output rows) for a mel frame count."""
    leave = input_lengths % 100
    feat = (leave - 1) // 2 + 1
    return ((feat - 1) // 2 + 1 - 1) // 2 + 1 + (input_lengths // 100) * 13
