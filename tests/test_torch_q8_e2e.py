"""The per-layer decode path vs the JAX package at the tiny config:
`Qwen3ASR(quantize="q8_0" | False, kv_cache="bf16" | "int8").transcribe`
(PCM -> mel -> encoder -> prompt splice -> prefill -> greedy decode through
`decoder_forward` at T = 1) against the JAX `Qwen3ASR` with the same modes
and the same weights on the CPU (`transcribe_fused`, its single-dispatch
path).

The JAX CPU program runs the reference's XLA paths (dequantize-and-dot, the
masked XLA decode attention), the port the plain twins of K4-K7, which
compute what the TPU kernels compute (bf16 dequant for the wide outputs,
one f32 softmax with the fresh column). So tokens are held under the
near-tie rule, as in tests/test_torch_e2e.py: run teacher-forced on the JAX
tokens, each port argmax equals the JAX token or trails it by at most
NEAR_TIE_TOL in the port's logits; the free-running port output equals the
JAX output up to the first such near tie. The decoder's matrices are drawn
GAIN times wider than the package's init, so that the layers, not the token
embedding, decide the tokens (tests/test_torch_batch.py::jax_and_port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu_torch.audio.mel import filters_t, generate_mel_filters, mel_device
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.e2e import _pad_pcm, transcribe_fused
from qwen3_asr_tpu_torch.models.encoder import encode
from qwen3_asr_tpu_torch.models.generate import cache_rows, decode_token, generate_greedy
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt

from helpers import make_byte_vocab
from test_torch_params import NEAR_TIE_TOL, port_config

MAX_TOKENS = 8
GAIN = 3
MODES = [("q8_0", "bf16"), ("q8_0", "int8"), (False, None)]


def pcm(seconds=1.5, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(t.shape)
    return (a * 32768.0).clip(-32768, 32767).astype(np.int16)


def jax_and_port(quantize, kv_cache, seed=7, gain=GAIN):
    """(JAX Qwen3ASR, the port's Qwen3ASR) with the same weights and modes
    on the CPU, EOS outside the vocab (fixed-length decode)."""
    from qwen3_asr_tpu.audio import generate_mel_filters as jax_filters
    from qwen3_asr_tpu.pipeline.asr import Qwen3ASR as JaxASR
    from qwen3_asr_tpu.runtime import params as jparams
    from qwen3_asr_tpu.text.bpe import BPETokenizer

    cfg = tiny_asr_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               eos_token_id=-1))
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, seed, jnp.bfloat16))
    lay = p["decoder"]["layers"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        lay[k] = (lay[k].astype(np.float32) * gain).astype(lay[k].dtype)
    dec = p["decoder"]
    if quantize:
        dec = jparams.quantize_decoder_params(dec, "q8_0")
    p["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(dec))
    tok = BPETokenizer(make_byte_vocab(cfg.decoder.vocab_size, {}), [])
    j = JaxASR(dtype=jnp.bfloat16, quantize=quantize, kv_cache=kv_cache)
    j.cfg, j.mel_filters, j.tokenizer = cfg, jax_filters(), tok
    j.params = jax.tree.map(jnp.asarray, p)
    t = Qwen3ASR(quantize=quantize, kv_cache=kv_cache, device="cpu")
    t.cfg = port_config(cfg)
    t.params, t.tokenizer = from_jax_params(p, t.cfg), tok
    t.filters_t = filters_t(generate_mel_filters(), "cpu")
    return j, t


def teacher_forced_logits(t, samples, tokens):
    """The port's logits at every step, fed the given tokens: the prefill,
    then the greedy loop's decode_token per token."""
    cfg, dec = t.cfg, t.params["decoder"]
    dcfg = cfg.decoder
    buf, n_frames = _pad_pcm(samples)
    mel = mel_device(torch.from_numpy(buf), t.filters_t, n_frames).T
    feats = encode(t.params["encoder"], cfg.encoder, mel, n_frames)
    prompt = build_asr_prompt(feats.shape[0], dcfg)
    off, P = audio_start_pos(prompt, dcfg), len(prompt)
    cache = tdec.init_kv_cache(dcfg, cache_rows(P, len(tokens)), "cpu", t.cache_dtype)
    h0 = tdec.embed_with_audio(dec, torch.tensor(prompt), feats, feats.shape[0], off)
    h = tdec.decoder_forward(dec, dcfg, h0, cache, P)
    logits = [tdec.lm_logits(dec, dcfg, h[P - 1])]
    for i in range(1, len(tokens)):
        buf = torch.tensor([tokens[i - 1], 0], dtype=torch.int32)
        logits.append(decode_token(dec, dcfg, cache, buf, 1, P + i - 1))
    return logits


@pytest.mark.parametrize("quantize,kv_cache", MODES)
def test_transcribe_matches_jax(quantize, kv_cache):
    from qwen3_asr_tpu.pipeline.asr import TranscribeParams as JaxParams

    j, t = jax_and_port(quantize, kv_cache)
    samples = pcm()
    want = j.transcribe(samples, JaxParams(max_tokens=MAX_TOKENS, fused=True,
                                           print_timing=False)).tokens
    got = t.transcribe(samples, TranscribeParams(max_tokens=MAX_TOKENS))
    assert got.success and len(want) == MAX_TOKENS
    assert "mega" not in t.params["decoder"]
    assert ("lm_head_q8" in t.params["decoder"]) == bool(quantize)
    first_tie = len(want)
    for i, lg in enumerate(teacher_forced_logits(t, samples, want)):
        best = int(torch.argmax(lg))
        if best != want[i]:
            gap = float(lg[best] - lg[want[i]])
            assert gap <= NEAR_TIE_TOL, (i, best, want[i], gap)
            first_tie = min(first_tie, i)
    assert got.tokens[:first_tie] == want[:first_tie]
    assert len(set(want)) > 1   # the layers, not one embedding row, decide


@pytest.mark.parametrize("quantize,kv_cache", MODES)
def test_free_run_is_the_teacher_forced_argmax(quantize, kv_cache):
    """The greedy loop's tokens are the argmaxes of its own teacher-forced
    logits: the loop's positions (pos = n_prompt + i - 1) and cache writes
    are those of decoder_forward at T = 1."""
    _, t = jax_and_port(quantize, kv_cache, seed=8)
    samples = pcm(1.0, 2)
    out, n_kept = transcribe_fused(t.params, t.cfg, samples, t.filters_t, MAX_TOKENS,
                                   cache_dtype=t.cache_dtype)
    assert n_kept == MAX_TOKENS
    tokens = [int(x) for x in out]
    logits = teacher_forced_logits(t, samples, tokens)
    assert [int(torch.argmax(lg)) for lg in logits] == tokens


def test_eos_stops_the_per_layer_loop():
    """n_kept counts the tokens before the first EOS, as in the int4 loop."""
    _, t = jax_and_port("q8_0", "bf16")
    samples = pcm()
    free, n = transcribe_fused(t.params, t.cfg, samples, t.filters_t, MAX_TOKENS)
    assert n == MAX_TOKENS
    eos = int(free[2])
    first = list(free).index(eos)
    t.cfg = dataclasses.replace(t.cfg, decoder=dataclasses.replace(
        t.cfg.decoder, eos_token_id=eos))
    out, n_kept = transcribe_fused(t.params, t.cfg, samples, t.filters_t, MAX_TOKENS)
    assert n_kept == first
    np.testing.assert_array_equal(out[:first], free[:first])


def test_modes_and_their_errors():
    j, t = jax_and_port(True, None)
    assert t.quantize == "q8_0" and t.kv_cache == "bf16" and t.cache_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="batched"):
        t.transcribe_batch([pcm()])
    for kw in (dict(quantize="int8pc"), dict(quantize="auto"),
               dict(quantize="q8_0", kv_cache="int4")):
        with pytest.raises(NotImplementedError, match="next PRs, item 3"):
            Qwen3ASR(device="cpu", **kw)
    with pytest.raises(ValueError):
        Qwen3ASR(quantize="q4", device="cpu")
    with pytest.raises(NotImplementedError):
        generate_greedy({"mega": {}}, t.cfg.decoder, torch.zeros(4, dtype=torch.int32),
                        4, None, 0, 0, 2, cache_dtype=torch.bfloat16)
    no_dak = dataclasses.replace(t.cfg.decoder, use_decode_attn_kernel=False)
    cache = tdec.init_kv_cache(no_dak, 8, "cpu", torch.bfloat16)
    x = torch.zeros(1, no_dak.hidden_size, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="use_decode_attn_kernel"):
        tdec.decoder_forward(t.params["decoder"], no_dak, x, cache, 2, prefill=False,
                             cache_offset=1)


def test_load_model_q8_0_gguf(tmp_path):
    """A Q8_0 GGUF through Qwen3ASR(quantize="q8_0").load_model keeps GGML's
    blocks as the layers' leaves and transcribes as the same leaves handed
    over from the JAX loader do."""
    from qwen3_asr_tpu.runtime import params as jparams
    from qwen3_asr_tpu.runtime.gguf import GGML_TYPE_Q8_0
    from helpers import write_tiny_gguf

    cfg = tiny_asr_config()
    dense = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 17, jnp.float32))
    path = str(tmp_path / "q8.gguf")
    write_tiny_gguf(path, cfg, dense, vocab=make_byte_vocab(cfg.decoder.vocab_size, {}),
                    merges=[], weight_type=GGML_TYPE_Q8_0)
    asr = Qwen3ASR(quantize="q8_0", kv_cache="int8", device="cpu")
    assert asr.load_model(path), asr.error_msg
    res = asr.transcribe(pcm(1.0, 4), TranscribeParams(max_tokens=5))
    assert res.success and len(res.tokens) <= 5
    _, jp, _, _ = jparams.load_asr_model(path)
    jp = jax.tree.map(np.asarray, jp)
    jp["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(jp["decoder"], "q8_0")))
    tp = from_jax_params(jp, asr.cfg)
    for key in ("wqkv", "wo", "w_gate_up", "w_down"):
        for sub in ("q8:q", "q8:s"):
            assert torch.equal(asr.params["decoder"]["layers"][key][sub],
                               tp["decoder"]["layers"][key][sub]), (key, sub)
    out, n_kept = transcribe_fused(tp, asr.cfg, pcm(1.0, 4), asr.filters_t, 5,
                                   cache_dtype=torch.int8)
    assert [int(x) for x in out[:n_kept]] == res.tokens
