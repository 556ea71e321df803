"""The port's forced aligner vs the JAX package at the tiny aligner config,
on the CPU: the windowed attention and encoder, the non-autoregressive pass
and its classify head, `ForcedAligner` (staged, bucketed, fused and
`align_batch`, in every weight mode), the text functions and
`transcribe_and_align`.

Tolerances, each with its reason:
- block-diagonal attention, f32: atol 1e-5 (the same f32 products and
  softmax, summed in another order);
- the windowed encoder, f32 weights: rtol 1e-4, atol 1e-4, as
  tests/test_torch_encoder.py;
- the NAR pass, f32: hidden states atol 1e-4 and classify logits atol 1e-4;
  bf16: hidden states relative L2 < 2e-2 (the JAX CPU program keeps bf16
  intermediates in f32, ROADMAP Queue 3) and logits within 2e-2 of their
  largest magnitude; classes equal wherever JAX's top-two gap is at least
  NEAR_TIE_TOL (0.2), which holds at most of the rows;
- words and timestamps: equal (f32 weights; the classes match exactly on
  these seeded inputs).

The decoder's matrices and the classify head are drawn GAIN times wider
than the package's init, so the classes depend on the audio and the
position and their logit gaps are mostly above the near-tie rule's 0.2.
"""

import dataclasses
import json
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from qwen3_asr_tpu.config import tiny_aligner_config, tiny_asr_config
from qwen3_asr_tpu.models import encoder as jenc
from qwen3_asr_tpu.models.decoder import classify_logits as j_classify
from qwen3_asr_tpu.models.generate import nar_forward as j_nar
from qwen3_asr_tpu.ops.attention import block_diagonal_attention as j_bda
from qwen3_asr_tpu.runtime import params as jparams
from qwen3_asr_tpu.text import korean as jko
from qwen3_asr_tpu.text import subtitles as jsub
from qwen3_asr_tpu.text import timestamps as jts
from qwen3_asr_tpu_torch.models import encoder as tenc
from qwen3_asr_tpu_torch.models.decoder import classify_logits as t_classify
from qwen3_asr_tpu_torch.models.generate import nar_forward as t_nar
from qwen3_asr_tpu_torch.models.generate import nar_forward_batch as t_nar_batch
from qwen3_asr_tpu_torch.ops.attention import block_diagonal_attention as t_bda
from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
from qwen3_asr_tpu_torch.runtime.params import (
    from_jax_params,
    fuse_decoder_params,
    to_torch,
)
from qwen3_asr_tpu_torch.text import korean as tko
from qwen3_asr_tpu_torch.text import subtitles as tsub
from qwen3_asr_tpu_torch.text import timestamps as tts

from helpers import make_byte_vocab
from test_torch_params import NEAR_TIE_TOL, port_config

GAIN = 8          # the decoder's matrices and the classify head, wider
WINDOW = 104      # 13 rows x 800 / 100 frames
CFG = tiny_aligner_config()
TCFG = port_config(CFG)


def pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = 0.3 * np.sin(2 * np.pi * (220 + 110 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return (a * 32768.0).clip(-32768, 32767).astype(np.int16)


# 50 classes of 80 ms reach 4 s: audio past that keeps the words unclamped
AUDIO = [pcm(4.3, 0), pcm(2.7, 1), pcm(4.05, 2)]
TEXTS = ["hello bucketed world", "one two three four five", "zeta"]


def jax_tree(dtype=jnp.float32, seed=23):
    """The JAX package's aligner tree as numpy, its decoder matrices and
    classify head GAIN times wider."""
    p = jax.tree.map(np.asarray, jparams.init_aligner_params(CFG, seed, dtype))
    dec = p["decoder"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        dec["layers"][k] = (dec["layers"][k].astype(np.float32) * GAIN).astype(dtype)
    dec["classify_w"] = (dec["classify_w"].astype(np.float32) * GAIN).astype(dtype)
    return p


def gaps(logits: np.ndarray) -> np.ndarray:
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def assert_classes(got, want, want_logits):
    """Equal classes outside near ties (JAX's top-two gap < NEAR_TIE_TOL),
    and most rows outside them."""
    g = gaps(want_logits)
    sure = g >= NEAR_TIE_TOL
    assert sure.mean() > 0.5, f"{sure.mean():.2f} of rows outside near ties"
    np.testing.assert_array_equal(np.asarray(got)[sure], np.asarray(want)[sure])


# -- block-diagonal attention --------------------------------------------------

@pytest.mark.parametrize("T", [WINDOW - 1, WINDOW, 2 * WINDOW + 7])
@pytest.mark.parametrize("inside_last", [False, True], ids=["all-valid", "n_valid"])
def test_block_diagonal_attention_matches_jax(T, inside_last):
    """T below, at and past whole windows; n_valid inside the last window
    masks its tail keys. Every row stays finite, padding rows included."""
    rng = np.random.default_rng(T)
    q, k, v = (rng.standard_normal((T, 4, 16)).astype(np.float32) for _ in range(3))
    n_valid = T - 5 if inside_last else None
    want = np.asarray(j_bda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), WINDOW,
                            0.25, n_valid=None if n_valid is None else jnp.int32(n_valid)))
    got = t_bda(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), WINDOW,
                0.25, n_valid=n_valid).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# -- the windowed encoder ------------------------------------------------------

@pytest.fixture(scope="module")
def enc():
    p = jax.tree.map(np.asarray, jparams.init_encoder_params(
        CFG.encoder, jax.random.PRNGKey(5), jnp.float32))
    rng = np.random.default_rng(5)
    for k in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        p["layers"][k] = (0.02 * rng.standard_normal(p["layers"][k].shape)).astype(np.float32)
    return p, jax.tree.map(to_torch, p)


@pytest.mark.parametrize("n_frames", [900, 1230])
def test_windowed_encode_matches_jax(enc, n_frames):
    """900 frames: 117 rows, one full window and a 13-row tail; 1230: 159
    rows whose tail chunk is short."""
    p, tp = enc
    mel = np.random.default_rng(n_frames).standard_normal((128, n_frames)).astype(np.float32)
    want = np.asarray(jenc._encode_jit(p, CFG.encoder, jnp.asarray(mel), n_frames))
    got = tenc.encode(tp, TCFG.encoder, torch.from_numpy(mel), n_frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_windowed_encode_padded_matches_jax(enc):
    """The bucketed entries: one utterance (930 true frames in a 1,200-frame
    bucket: n_audio 121 lands inside the second window) and a batch of
    three in one bucket, each item's keys past its n_audio masked."""
    p, tp = enc
    rng = np.random.default_rng(1)
    n_true = [930, 1200, 401]
    mels = np.zeros((3, 128, 1200), np.float32)
    for b, n in enumerate(n_true):
        mels[b, :, :n] = rng.standard_normal((128, n))
    want, na = jenc.encode_audio_padded(p, CFG.encoder, jnp.asarray(mels[0]), n_true[0])
    got, nt = tenc.encode_audio_padded(tp, TCFG.encoder, torch.from_numpy(mels[0]), n_true[0])
    assert nt == na == 121
    np.testing.assert_allclose(got.numpy()[:nt], np.asarray(want)[:na], rtol=1e-4, atol=1e-4)
    wb, nab = jenc.encode_audio_padded_batch(p, CFG.encoder, jnp.asarray(mels), n_true)
    gb, ntb = tenc.encode_audio_padded_batch(tp, TCFG.encoder, torch.from_numpy(mels), n_true)
    assert list(ntb) == list(nab)
    assert np.isfinite(gb.numpy()).all()
    for b, n in enumerate(ntb):
        np.testing.assert_allclose(gb.numpy()[b, :n], np.asarray(wb)[b, :n],
                                   rtol=1e-4, atol=1e-4)


# -- the NAR pass and the classify head ----------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nar_forward_and_classify_match_jax(dtype):
    """One prompt of 200 rows bucketed to 256 (rows past 200 masked), 40
    audio rows at offset 1."""
    jdt = getattr(jnp, dtype)
    p = jax_tree(jdt)
    dec, dcfg = p["decoder"], CFG.decoder
    tdec = fuse_decoder_params(from_jax_params(p, TCFG)["decoder"])
    rng = np.random.default_rng(9)
    P, n_valid, n_audio = 256, 200, 40
    toks = rng.integers(0, dcfg.vocab_size, P).astype(np.int32)
    audio = rng.standard_normal((n_audio, dcfg.hidden_size)).astype(np.float32)
    jd = jax.tree.map(jnp.asarray, dec)
    jh = j_nar(jd, dcfg, jnp.asarray(toks), jnp.asarray(audio, jdt), jnp.int32(n_audio), 1,
               n_valid=jnp.int32(n_valid))
    want_h = np.asarray(jh, np.float32)[:n_valid]
    want = np.asarray(j_classify(jd, dcfg, jh))[:n_valid]
    th = t_nar(tdec, TCFG.decoder, torch.from_numpy(toks),
               torch.from_numpy(audio).to(tdec["token_embd"].dtype), n_audio, 1, n_valid=n_valid)
    got_h = th.float().numpy()[:n_valid]
    got = t_classify(tdec, TCFG.decoder, th[:n_valid]).numpy()
    assert got.shape == (n_valid, dcfg.classify_num) and np.isfinite(th.float().numpy()).all()
    if dtype == "float32":
        np.testing.assert_allclose(got_h, want_h, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        rel = np.linalg.norm(got_h - want_h) / np.linalg.norm(want_h)
        assert rel < 2e-2, rel
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert_classes(got.argmax(-1), want.argmax(-1), want)


def test_nar_forward_batch_matches_single():
    """A batch of three prompts with different valid lengths and audio
    lengths equals three single passes (f32)."""
    p = jax_tree()
    tdec, dcfg = fuse_decoder_params(from_jax_params(p, TCFG)["decoder"]), TCFG.decoder
    rng = np.random.default_rng(4)
    P = 128
    toks = torch.from_numpy(rng.integers(0, dcfg.vocab_size, (3, P)).astype(np.int32))
    audio = torch.from_numpy(rng.standard_normal((3, 30, dcfg.hidden_size)).astype(np.float32))
    n_audio, n_valid = [30, 12, 25], [128, 77, 40]
    hb = t_nar_batch(tdec, dcfg, toks, audio, n_audio, 1, n_valid)
    for b in range(3):
        h1 = t_nar(tdec, dcfg, toks[b], audio[b], n_audio[b], 1, n_valid=n_valid[b])
        np.testing.assert_allclose(hb[b, :n_valid[b]].numpy(), h1[:n_valid[b]].numpy(),
                                   atol=1e-5, rtol=0)


# -- ForcedAligner -------------------------------------------------------------

def aligners(quantize):
    """(JAX ForcedAligner, the port's) on the same f32 weights in mode
    `quantize`, each quantizing the same dense tree itself."""
    from qwen3_asr_tpu.audio import generate_mel_filters
    from qwen3_asr_tpu.pipeline.aligner import ForcedAligner as JaxAligner
    from qwen3_asr_tpu.text.bpe import BPETokenizer

    p = jax_tree()
    vocab = make_byte_vocab(CFG.decoder.vocab_size, {})
    j = JaxAligner(dtype=jnp.float32, quantize=quantize)
    j.cfg, j.mel_filters = CFG, generate_mel_filters()
    j.tokenizer = BPETokenizer(vocab, [])
    j.params = jax.tree.map(jnp.asarray, p)
    j._prepare_decoder()
    t = ForcedAligner(quantize=quantize, device="cpu", dtype=torch.float32)
    t._finish_load(TCFG, from_jax_params(p, TCFG), vocab, [])
    return j, t


def words(r):
    assert r.success, r.error_msg
    return [(w.word, w.start, w.end) for w in r.words]


@pytest.mark.parametrize("quantize", [False, "int8pc", "q8_0", "auto"])
def test_forced_aligner_matches_jax(quantize):
    """Staged, bucketed (mel_bucket 200), fused and align_batch: the JAX
    package's words and timestamps; the timestamps are not all clamped to
    the audio's end, and the int8 modes carry no lm head copy."""
    j, t = aligners(quantize)
    dec = t.params["decoder"]
    assert "lm_head_pc" not in dec and "lm_head_q8" not in dec and "mega" not in dec
    if quantize:
        assert isinstance(dec["layers"]["wqkv"], dict)
    for kw in ({}, {"mel_bucket": 200}, {"fused": True}):
        got = words(t.align(AUDIO[0], TEXTS[0], **kw))
        assert got == words(j.align(AUDIO[0], TEXTS[0], **kw)), kw
        assert any(0 < e < 4.3 for _, _, e in got), got
    got_b = [words(r) for r in t.align_batch(AUDIO, TEXTS, mel_bucket=200)]
    want_b = [words(r) for r in j.align_batch(AUDIO, TEXTS, mel_bucket=200)]
    assert got_b == want_b


def test_forced_aligner_gguf_and_errors(tmp_path):
    """A tiny aligner GGUF loads (classify head, windowed encoder, vocab
    and timestamp metadata) and aligns as the JAX package's loader does;
    a missing file, a missing model and an 8 kHz WAV fail with the JAX
    package's messages."""
    from qwen3_asr_tpu.audio import write_wav
    from qwen3_asr_tpu.pipeline.aligner import ForcedAligner as JaxAligner
    from helpers import write_tiny_gguf

    p = jax_tree()
    path = str(tmp_path / "fa.gguf")
    write_tiny_gguf(path, CFG, p, aligner=True,
                    vocab=make_byte_vocab(CFG.decoder.vocab_size, {}), merges=[])
    j = JaxAligner(dtype=jnp.float32)
    assert j.load_model(path), j.error_msg
    t = ForcedAligner(device="cpu", dtype=torch.float32)
    assert t.load_model(path), t.error_msg
    assert t.cfg == port_config(j.cfg) and t.cfg.decoder.classify_num == 50
    assert t.params["decoder"]["classify_w"].shape == (64, CFG.decoder.classify_num)
    assert words(t.align(AUDIO[0], TEXTS[0])) == words(j.align(AUDIO[0], TEXTS[0]))
    assert not ForcedAligner(device="cpu").load_model(str(tmp_path / "none.gguf"))
    r = ForcedAligner(device="cpu").align(AUDIO[0], "x")
    assert not r.success and r.error_msg == "Model not loaded"
    w8k = str(tmp_path / "s8k.wav")
    write_wav(w8k, np.zeros(800, np.float32), sample_rate=8000)
    r = t.align(w8k, "x")
    assert not r.success and r.error_msg == "Audio must be 16kHz, got 8000 Hz"
    assert ForcedAligner(quantize="int4", device="cpu").quantize == "int8pc"
    with pytest.raises(ValueError):
        ForcedAligner(quantize="int2", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ForcedAligner()


# -- the text functions --------------------------------------------------------

@pytest.mark.parametrize("data", [
    [1, 2, 3, 5, 8, 8, 9], [1, 2, 100, 3, 4], [10, 90, 80, 70, 20, 30],
    [10, 90, 80, 70, 20], [], [5], [3, 2, 1], [0, 0, 0, 50, 49, 1, 2, 2]])
def test_fix_timestamp_classes_cases(data):
    """Every case of tests/test_text.py's test_lis_repair_* and a few more:
    byte-equal to the JAX package's pure-Python repair."""
    assert tts.fix_timestamp_classes(data) == jts.fix_timestamp_classes_py(data)
    assert tts.fix_timestamp_classes_py(data) == jts.fix_timestamp_classes_py(data)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5000), max_size=40))
def test_fix_timestamp_classes_drawn(data):
    assert tts.fix_timestamp_classes(data) == jts.fix_timestamp_classes_py(data)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 5000), max_size=20),
       st.lists(st.text(string.ascii_letters + "가나다", min_size=1, max_size=6), max_size=12),
       st.floats(0.0, 500.0), st.sampled_from([80, 40]))
def test_timestamps_and_pairing_drawn(classes, words_, duration, seg):
    ts = tts.classes_to_timestamps(classes, seg)
    assert ts == jts.classes_to_timestamps(classes, seg)
    assert tts.pair_words(words_, ts, duration) == jts.pair_words(words_, ts, duration)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.tuples(st.text(string.ascii_letters + "ü가", min_size=1, max_size=9),
                          st.floats(0.0, 30.0), st.floats(0.0, 3.0)), max_size=25))
def test_subtitles_drawn(raw):
    """words_to_srt / words_to_vtt byte-equal to the JAX package's on
    drawn words (starts sorted, ends after starts)."""
    t0, out = 0.0, []
    for word, gap, length in raw:
        t0 += gap / 10
        out.append({"word": word, "start": t0, "end": t0 + length})
    assert tsub.words_to_srt(out) == jsub.words_to_srt(out)
    assert tsub.words_to_vtt(out) == jsub.words_to_vtt(out)
    assert tsub.words_to_srt(out, max_chars=10) == jsub.words_to_srt(out, max_chars=10)


def test_korean_split_matches_jax():
    """The vendored dictionary: found, loaded to the same words, and the
    same splits on Korean text (dictionary hits, misses, short words)."""
    path = tko.find_korean_dict()
    assert path and path == jko.find_korean_dict()
    d = tko.load_korean_dict(path)
    assert d == jko.load_korean_dict(path) and len(d) > 1000
    words_ = sorted(d)[:200:7]
    text = " ".join(w + "에서" for w in words_) + " 안녕하세요 나는 학생입니다 가"
    assert tko.tokenize_korean(text, d) == jko.tokenize_korean(text, d)
    assert tko.tokenize_korean(text, set()) == jko.tokenize_korean(text, set())


# -- transcribe_and_align --------------------------------------------------------

def test_transcribe_and_align_matches_jax(tmp_path):
    """The combined mode, fused and staged, against the JAX package's on the
    same tiny ASR and aligner weights: transcript, language and words equal;
    language_override 'korean' loads the vendored dictionary; the JSON
    render equals the JAX package's; a WAV at 8 kHz fails with the ASR
    leg's message."""
    from qwen3_asr_tpu.audio import write_wav
    from qwen3_asr_tpu.pipeline.asr import Qwen3ASR as JaxASR
    from qwen3_asr_tpu.pipeline.asr import TranscribeParams as JParams
    from qwen3_asr_tpu.pipeline.combined import alignment_to_json as j_json
    from qwen3_asr_tpu.pipeline.combined import transcribe_and_align as j_ta
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.pipeline.combined import alignment_to_json, transcribe_and_align

    acfg = tiny_asr_config()
    vocab = make_byte_vocab(acfg.decoder.vocab_size, {})
    ja = JaxASR(dtype=jnp.float32)
    ja.load_random(acfg, seed=31, vocab=vocab)
    ta = Qwen3ASR(device="cpu", dtype=torch.float32)
    ap = jax.tree.map(np.asarray, jparams.init_asr_params(acfg, 31, jnp.float32))
    ta._finish_load(port_config(acfg), from_jax_params(ap, port_config(acfg)), vocab, [])
    jf, tf = aligners(False)
    audio = AUDIO[0]
    for fused in (False, True):
        kw = dict(max_tokens=6, print_timing=False, prompt_bucket=32, fused=fused)
        want = j_ta(ja, jf, audio, JParams(**kw))
        got = transcribe_and_align(ta, tf, audio, TranscribeParams(**kw))
        assert got.success, got.error_msg
        assert got.asr.tokens == want.asr.tokens and got.transcript == want.transcript
        assert got.detected_language == want.detected_language
        assert words(got.alignment) == words(want.alignment)
        assert alignment_to_json(got.alignment) == j_json(want.alignment)
        json.loads(alignment_to_json(got.alignment))
    kw = dict(max_tokens=6, print_timing=False, prompt_bucket=32)
    got = transcribe_and_align(ta, tf, audio, TranscribeParams(**kw), language_override="korean")
    want = j_ta(ja, jf, audio, JParams(**kw), language_override="korean")
    assert got.success and len(tf.ko_dict) == len(jf.ko_dict) > 1000
    assert words(got.alignment) == words(want.alignment)
    w8k = str(tmp_path / "s8k.wav")
    write_wav(w8k, np.zeros(800, np.float32), sample_rate=8000)
    got = transcribe_and_align(ta, tf, w8k, TranscribeParams(fused=True, print_timing=False))
    assert got.error_msg == "ASR failed: Audio must be 16kHz, got 8000 Hz"
