"""The port's whole slice vs the JAX package at the tiny config: int16 PCM
-> mel -> encoder -> prompt splice -> int8pc prefill -> int4 / int8-KV
greedy decode.

The JAX reference composes `_mel_device` + `_encode_jit` +
`generate_greedy(..., cache_dtype=int8, _force_mega_interpret=True)` (on
the CPU `transcribe_fused` would take the non-megakernel loop). Greedy
tokens must be equal under the near-tie rule (scripts/chipgate.py): run
teacher-forced on the JAX tokens, each port argmax equals the JAX token or
trails it by at most NEAR_TIE_TOL in the port's logits; the free-running
port output equals the JAX output up to the first such near tie.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.audio.mel import _mel_device, filters_t_device
from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.encoder import _encode_jit
from qwen3_asr_tpu.models.generate import generate_greedy as jax_generate
from qwen3_asr_tpu.ops.megakernel import pack_megakernel_params
from qwen3_asr_tpu.text.prompt import audio_start_pos, build_asr_prompt
from qwen3_asr_tpu_torch.audio.mel import filters_t, generate_mel_filters
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.e2e import _pad_pcm, expected_n_audio, transcribe_fused
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import NEAR_TIE_TOL, jax_tree, port_config

MAX_TOKENS = 8


def _pcm(seconds=2.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape)
    return (a * 32768.0).clip(-32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config()
    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, eos_token_id=-1))
    tree = jax_tree(cfg, seed=2)
    tp = from_jax_params(tree, port_config(cfg))
    tree["decoder"]["mega"] = pack_megakernel_params(tree["decoder"], cfg.decoder,
                                                     int4=True)
    pcm = _pcm()
    buf, n_frames = _pad_pcm(pcm)
    filters = generate_mel_filters()
    mel = _mel_device(jnp.asarray(buf), filters_t_device(filters), n_frames).T
    feats = _encode_jit(tree["encoder"], cfg.encoder, mel, n_frames)
    n_audio = int(feats.shape[0])
    assert n_audio == expected_n_audio(n_frames)
    prompt = build_asr_prompt(n_audio, cfg.decoder)
    off = audio_start_pos(prompt, cfg.decoder)
    out, n_kept = jax_generate(
        tree["decoder"], cfg.decoder, jnp.asarray(prompt, jnp.int32),
        jnp.int32(len(prompt)), feats, jnp.int32(n_audio), off, MAX_TOKENS,
        cache_dtype=jnp.int8, _force_mega_interpret=True)
    jax_tokens = [int(t) for t in np.asarray(out)[:int(n_kept)]]
    return cfg, tp, pcm, filters, jax_tokens, (prompt, off, n_audio, feats)


def _teacher_forced_logits(cfg, tp, prompt, off, feats, n_audio, tokens):
    """Port logits at every step, fed the given tokens."""
    dcfg, dec = port_config(cfg.decoder), tp["decoder"]
    P = len(prompt)
    S = -(-(P + MAX_TOKENS) // 128) * 128
    cache = tdec.init_kv_cache(dcfg, S, "cpu")
    audio = torch.from_numpy(np.asarray(feats, np.float32)).to(torch.bfloat16)
    h0 = tdec.embed_with_audio(dec, torch.tensor(prompt), audio, n_audio, off)
    h = tdec.decoder_forward(dec, dcfg, h0, cache, P)
    logits = [tdec.lm_logits(dec, dcfg, h[P - 1])]
    L, DKV = dcfg.n_layers, dcfg.n_kv_heads * dcfg.head_dim
    k3, v3 = cache["k"].view(L, S, DKV), cache["v"].view(L, S, DKV)
    for i in range(1, len(tokens)):
        _, _, lg = tmk.mega_decode_step_ref(
            dec["mega"], dcfg, torch.tensor([tokens[i - 1]], dtype=torch.int32),
            P + i - 1, k3, v3, cache["k_s"], cache["v_s"], return_logits=True)
        logits.append(lg)
    return logits


def test_transcribe_matches_jax(setup):
    cfg, tp, pcm, filters, jax_tokens, (prompt, off, n_audio, feats) = setup
    assert len(jax_tokens) == MAX_TOKENS
    out, n_kept = transcribe_fused(tp, port_config(cfg), pcm, filters_t(filters, "cpu"),
                                   MAX_TOKENS, cache_dtype=torch.int8)
    assert n_kept == MAX_TOKENS
    port = [int(t) for t in out[:n_kept]]
    logits = _teacher_forced_logits(cfg, tp, prompt, off, feats, n_audio,
                                    jax_tokens)
    first_tie = len(jax_tokens)
    for i, (lg, want) in enumerate(zip(logits, jax_tokens)):
        got = int(torch.argmax(lg))
        if got != want:
            gap = float(lg[got] - lg[want])
            assert gap <= NEAR_TIE_TOL, (i, got, want, gap)
            first_tie = min(first_tie, i)
    assert port[:first_tie] == jax_tokens[:first_tie]


def test_eos_stops_and_is_dropped(setup):
    """n_kept counts the tokens before the first EOS, as the JAX loop does,
    though the port's host only checks for EOS every few steps."""
    from qwen3_asr_tpu_torch.models.generate import generate_greedy

    cfg, tp, *_ , (prompt, off, n_audio, feats) = setup
    dec = tp["decoder"]
    audio = torch.from_numpy(np.asarray(feats, np.float32)).to(torch.bfloat16)
    toks = torch.tensor(prompt, dtype=torch.int32)
    free, n = generate_greedy(dec, port_config(cfg.decoder), toks, len(prompt), audio, n_audio,
                              off, MAX_TOKENS)
    assert n == MAX_TOKENS
    eos = int(free[3])
    first = list(free).index(eos)
    dcfg = port_config(dataclasses.replace(cfg.decoder, eos_token_id=eos))
    out, n_kept = generate_greedy(dec, dcfg, toks, len(prompt), audio, n_audio,
                                  off, MAX_TOKENS)
    assert n_kept == first
    np.testing.assert_array_equal(out[:first], free[:first])


def test_pipeline_load_model_from_gguf(tmp_path):
    """Qwen3ASR.load_model reads a tiny GGUF through the shared reader and
    transcribes exactly as the same weights loaded from the JAX loader."""
    from helpers import make_byte_vocab, write_tiny_gguf
    from qwen3_asr_tpu.runtime import params as jparams

    cfg = tiny_asr_config()
    dense = jax_tree(cfg, seed=4, quantize=False)
    f32 = {k: {kk: (np.asarray(vv, np.float32) if not isinstance(vv, dict) else
                    {a: np.asarray(b, np.float32) for a, b in vv.items()})
               for kk, vv in v.items()} for k, v in dense.items()}
    vocab = make_byte_vocab(cfg.decoder.vocab_size,
                            {cfg.decoder.eos_token_id: "<|im_end|>"})
    path = str(tmp_path / "asr.gguf")
    write_tiny_gguf(path, cfg, f32, vocab=vocab, merges=[])

    asr = Qwen3ASR(quantize="int4", kv_cache="int8", device="cpu")
    assert asr.load_model(path), asr.error_msg
    res = asr.transcribe(_pcm(1.5, 3), TranscribeParams(max_tokens=6, fused=True))
    assert res.success and len(res.tokens) <= 6

    jcfg, jp, _, _ = jparams.load_asr_model(path)
    assert asr.cfg == port_config(jcfg)
    import jax

    jp = jax.tree.map(np.asarray, jp)
    jp["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(jp["decoder"], "int8pc")))
    tp = from_jax_params(jp, port_config(jcfg))
    out, n_kept = transcribe_fused(tp, port_config(jcfg), _pcm(1.5, 3), asr.filters_t, 6,
                                   cache_dtype=torch.int8)
    assert [int(t) for t in out[:n_kept]] == res.tokens

    bad = Qwen3ASR(device="cpu")
    assert not bad.load_model(str(tmp_path / "missing.gguf"))
    assert "Failed to load model" in bad.error_msg


def test_load_model_truncated_gguf_returns_false(tmp_path):
    """A 9-byte GGUF (magic and version 3, then nothing): load_model returns
    False with the error message, as the JAX pipeline's does, instead of
    raising the reader's struct.error."""
    import struct

    from qwen3_asr_tpu.pipeline.asr import Qwen3ASR as JaxASR

    path = tmp_path / "short.gguf"
    path.write_bytes(b"GGUF" + struct.pack("<I", 3) + b"\x00")
    for asr in (JaxASR(), Qwen3ASR(device="cpu")):
        assert not asr.load_model(str(path))
        assert asr.error_msg.startswith("Failed to load model:")
    assert asr.params is None


@pytest.fixture(scope="module")
def wide_pair():
    from test_torch_batch import GAIN, jax_and_port

    return jax_and_port(gain=GAIN)


@pytest.mark.parametrize("n_samples", [0, 100])
def test_staged_under_one_mel_frame_matches_jax(wide_pair, n_samples):
    """Audio under one mel frame (160 samples) on the staged exact-shape
    path, TranscribeParams()'s default: the mel is empty, as the JAX
    package's is, and both answer success with the same tokens."""
    from qwen3_asr_tpu.pipeline.asr import TranscribeParams as JaxParams

    j, t = wide_pair
    pcm = (np.random.default_rng(n_samples).standard_normal(n_samples)
           * 3000).astype(np.int16)
    want = j.transcribe(pcm, JaxParams(max_tokens=6, print_timing=False))
    got = t.transcribe(pcm, TranscribeParams(max_tokens=6, print_timing=False))
    assert want.success and got.success, got.error_msg
    assert got.tokens == want.tokens and len(got.tokens) == 6


def test_pipeline_rejects_unported_modes(wide_pair, capsys):
    """Sampled and speculative decoding, which answered "not ported" before
    they were ported, now run on the CPU: spec_k gives the JAX package's
    int8pc greedy tokens over an int8 cache (its XLA path on the CPU), with
    the `spec:` line under print_timing; temperature > 0 with top_k = 1 gives
    the greedy tokens on an int8 decode pack (whose head is the int8pc head
    the sampled path applies to the step's hidden state); spec_k under
    sampling is ignored with a note; spec_k without a decode pack answers
    the message naming the quantized modes. The int4 cache and
    print_progress are accepted (their runs: tests/test_torch_kv4.py,
    tests/test_torch_streaming.py); an unknown quantize mode raises."""
    import copy

    from qwen3_asr_tpu.pipeline.asr import TranscribeParams as JaxParams
    from qwen3_asr_tpu_torch.models.generate import INT4_KV
    from qwen3_asr_tpu_torch.pipeline.asr import SPEC_NEEDS_PACK

    assert Qwen3ASR(kv_cache="int4", device="cpu").cache_dtype == INT4_KV
    with pytest.raises(ValueError, match="unknown quantize"):
        Qwen3ASR(quantize="q4", device="cpu")
    j, t = wide_pair
    pcm = _pcm(1.0)   # on 0.5 s step 3's top two logits tie within 0.005
    want = j.transcribe(pcm, JaxParams(max_tokens=6, print_timing=False)).tokens
    spec = t.transcribe(pcm, TranscribeParams(max_tokens=6, spec_k=3))
    assert spec.success and spec.tokens == want and len(want) == 6
    assert "spec: rounds=" in capsys.readouterr().err
    t8 = copy.copy(t)
    dec = dict(t.params["decoder"])
    dec["mega"] = tmk.pack_megakernel_params(dec, t.cfg.decoder, int4=False)
    t8.params = dict(t.params, decoder=dec)
    greedy = t8.transcribe(pcm, TranscribeParams(max_tokens=6, print_timing=False))
    for kw in (dict(temperature=0.8, top_k=1), dict(temperature=0.8, top_k=1, spec_k=2)):
        limit = t8.transcribe(pcm, TranscribeParams(max_tokens=6, print_timing=False, **kw))
        assert limit.success and limit.tokens == greedy.tokens
    assert "spec_k (greedy-exact speculation) does not apply" in capsys.readouterr().err
    nopack = copy.copy(t)
    nopack.params = dict(t.params, decoder={k: v for k, v in dec.items() if k != "mega"})
    res = nopack.transcribe(pcm, TranscribeParams(max_tokens=6, spec_k=2))
    assert not res.success and res.error_msg == SPEC_NEEDS_PACK
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Qwen3ASR(device="cuda")
