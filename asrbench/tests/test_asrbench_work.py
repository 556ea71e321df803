"""The yardstick's counts, by hand for Qwen3-ASR-0.6B."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT

from asrbench import weights, work

ASR = json.loads((ROOT / "asrbench" / "configs" / "qwen3-asr-0.6b.json").read_text())
FA = json.loads((ROOT / "asrbench" / "configs" / "qwen3-forced-aligner-0.6b.json").read_text())


def test_decoder_and_head_weights():
    # 28 x (1,024 x (2,048 + 2 x 1,024) + 2,048 x 1,024 + 3 x 1,024 x 3,072)
    assert work.decoder_layer_weights(ASR) == 440_401_920
    assert work.head_weights(ASR) == 1024 * 151_936 == 155_582_464


def test_cache_bytes_a_position():
    assert work.cache_row_bytes(ASR, "bf16") == 28 * 2 * 8 * 128 * 2 == 114_688
    assert work.cache_row_bytes(ASR, "int8") == 28 * (2 * 8 * 128 + 2 * 8 * 4)


def test_decode_step_by_hand():
    pos = 1_533
    nbytes, ops = work.step_work(ASR, [pos], "bf16")
    scales = 4 * (28 * (2048 + 1024 + 1024 + 1024 + 3072 + 3072 + 1024) + 151_936)
    assert nbytes == 440_401_920 + 155_582_464 + scales + (pos + 1) * 114_688
    attn = 28 * 2 * (pos + 1) * 16 * 128
    assert ops == 2 * (440_401_920 + 155_582_464) + 2 * attn
    # two rows share the weights
    nb2, ops2 = work.step_work(ASR, [pos, pos], "bf16")
    assert nb2 - nbytes == (pos + 1) * 114_688 and ops2 == 2 * ops
    assert work.bound(nbytes, ops, work.INT8_OPS) == pytest.approx(nbytes / 3.35e12)


def test_request_shapes():
    s = work.asr_request(ASR, 92 * 16000, 323)
    assert (s["n_frames"], s["n_audio"], s["n_prompt"]) == (9200, 1196, 1211)
    assert s["positions"][0] == 1211 and len(s["positions"]) == 322
    a = work.align_request(FA, 92 * 16000, 183)
    assert a["n_real"] == 2 + 1196 + 183 * 9 == 2845


def test_request_ops_by_hand():
    """A 92 s / 323-token request: prefill 1,211 rows, 322 steps."""
    n_prompt, steps = 1211, 322
    prefill = n_prompt * 440_401_920 + 28 * 2 * 16 * 128 * n_prompt * (n_prompt + 1) // 2
    decode = sum(440_401_920 + 155_582_464 + 28 * 2 * (p + 1) * 16 * 128
                 for p in range(n_prompt, n_prompt + steps))
    enc = work.encoder_macs(ASR, 9200)
    assert work.asr_request_ops(ASR, 92 * 16000, 323) == 2.0 * (enc + prefill + 155_582_464 + decode)
    # the encoder: 18 layers at T 1,196, full attention, d 896, FFN 3,584
    T, d = 1196, 896
    layers = 18 * (4 * T * d * d + 2 * T * d * 3584 + 2 * T * T * d)
    assert enc - layers == 92 * (9 * 480 * (64 * 50 + 480 * 32 * 25 + 480 * 16 * 13)
                                 + 13 * 480 * 16 * 896) + T * d * d + T * d * 1024


def test_windowed_encoder_counts_windows():
    T = 1196   # 11 windows of 104 rows and one of 52
    full = work.encoder_macs(dict(FA, audio=dict(FA["audio"], attention_window_rows=None)), 9200)
    win = work.encoder_macs(FA, 9200)
    assert full - win == 24 * 2 * (T * T - (11 * 104 * 104 + 52 * 52)) * 1024


def test_weights_cover_the_config():
    names = {p[-1] for g in weights.leaves(FA).values() for p, _ in g}
    assert {"classify_w", "classify_b", "token_embd", "conv1_w"} <= names
