"""Faults planted in the program's front end, for the checks that the
comparison deciding `correct` sees them: each replaces one function of the
program by a broken one, through `set(module, name, value)` (pytest's
`monkeypatch.setattr`, or `plain_set` in a tool's process).

- `mel_frames_shifted`: the log-mel comes out SHIFT frames late, the last
  ones wrapped to the front (every path: the exact, the bucketed and the
  batched one);
- `encoder_layer_skipped`: the encoder's first layer returns its input
  (the exact and the batched encoder);
- `attention_window_halved`: a windowed encoder attends within windows of
  half the configured rows (the aligner's encoder; the ASR encoder has no
  window and is not touched). The comparison sees it on most seeds, not
  all, so no test holds it; `tools/readings.py --fault` reads it.
"""

from __future__ import annotations

SHIFT = 8   # mel frames: one row of the encoder's output, the aligner's 80 ms step


def plain_set(module, name: str, value) -> None:
    setattr(module, name, value)


def mel_frames_shifted(set_=plain_set) -> None:
    import torch

    from qwen3_asr_tpu_torch.audio import mel
    from qwen3_asr_tpu_torch.models import e2e

    good = mel.mel_device

    def shifted(*a, **kw):
        return torch.roll(good(*a, **kw), SHIFT, dims=-2)

    set_(mel, "mel_device", shifted)
    set_(e2e, "mel_device", shifted)


def encoder_layer_skipped(set_=plain_set) -> None:
    from qwen3_asr_tpu_torch.models import encoder

    def skip_first(block):
        calls = [0]

        def broken(cfg, h, *a):
            calls[0] += 1
            if calls[0] % cfg.n_layers == 1 % cfg.n_layers:
                return h
            return block(cfg, h, *a)
        return broken

    set_(encoder, "_encoder_block", skip_first(encoder._encoder_block))
    set_(encoder, "_encoder_block_batch", skip_first(encoder._encoder_block_batch))


def attention_window_halved(set_=plain_set) -> None:
    from qwen3_asr_tpu_torch.models import encoder

    good = encoder.attention_window

    def halved(cfg):
        w = good(cfg)
        return None if w is None else max(1, w // 2)

    set_(encoder, "attention_window", halved)


FAULTS = {f.__name__: f for f in (mel_frames_shifted, encoder_layer_skipped,
                                  attention_window_halved)}
