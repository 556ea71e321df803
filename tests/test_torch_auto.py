"""The JAX package's default modes through the port, at the tiny config.

- `Qwen3ASR()` in both packages: dense weights and a bf16 cache, the same
  resolution of `quantize="auto"`, and the same tokens under the near-tie
  rule (the JAX CPU program runs the reference's XLA step, the port the
  per-layer step's twins, tests/test_torch_q8_e2e.py).
- `Qwen3ASR(quantize="auto")`, the JAX CLI's default: int8pc weights, the
  int8 decode pack and a bf16 cache, against the JAX megakernel in
  interpret mode (`generate_greedy(..., _force_mega_interpret=True)`, not
  its XLA int8pc step): teacher-forced on the JAX tokens, each port argmax
  equals the JAX token or trails it by at most NEAR_TIE_TOL; the
  free-running tokens equal up to the first such tie. The staged path
  (fused=False, and the bucketed frontend at mel_bucket > 0) gives the
  fused path's tokens.
- `quantize="auto"` on a Q8_0 GGUF keeps its blocks, as the JAX package does.

The decoder's matrices are drawn GAIN times wider than the package's init
(tests/test_torch_batch.py::jax_and_port), so the layers, not the token
embedding, decide the tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
from qwen3_asr_tpu_torch.runtime.params import from_jax_params

from helpers import make_byte_vocab
from test_torch_params import NEAR_TIE_TOL, port_config
from test_torch_q8_e2e import GAIN, pcm, teacher_forced_logits

MAX_TOKENS = 8


def dense_tree(seed=7, gain=GAIN):
    """The JAX package's dense init with the decoder's matrices `gain` times
    wider, EOS outside the vocab; as numpy."""
    from qwen3_asr_tpu.runtime import params as jparams

    cfg = tiny_asr_config()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, eos_token_id=-1))
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, seed, jnp.bfloat16))
    lay = p["decoder"]["layers"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        lay[k] = (lay[k].astype(np.float32) * gain).astype(lay[k].dtype)
    return cfg, p


def port_model(cfg, dense, **kw) -> Qwen3ASR:
    """The port's Qwen3ASR(**kw) loaded from the dense tree through its own
    load path (`auto` resolved, quantized, fused, packed there)."""
    t = Qwen3ASR(device="cpu", **kw)
    t._finish_load(port_config(cfg), from_jax_params(dense, port_config(cfg)),
                   make_byte_vocab(cfg.decoder.vocab_size, {}), [])
    return t


def first_tie_prefix(logits, want, got):
    """Near-tie rule: each port argmax equals want or trails it by at most
    NEAR_TIE_TOL; got equals want up to the first such tie."""
    first_tie = len(want)
    for i, lg in enumerate(logits):
        best = int(torch.argmax(lg))
        if best != want[i]:
            gap = float(lg[best] - lg[want[i]])
            assert gap <= NEAR_TIE_TOL, (i, best, want[i], gap)
            first_tie = min(first_tie, i)
    assert got[:first_tie] == want[:first_tie]


def test_defaults_match_jax():
    """Both packages' Qwen3ASR() resolve to dense weights and a bf16 cache,
    both resolve "auto" alike, and give the same tokens."""
    from qwen3_asr_tpu.pipeline.asr import Qwen3ASR as JaxASR
    from qwen3_asr_tpu.pipeline.asr import TranscribeParams as JaxParams
    from qwen3_asr_tpu.audio import generate_mel_filters
    from qwen3_asr_tpu.text.bpe import BPETokenizer

    cfg, dense = dense_tree()
    j = JaxASR()
    j.cfg, j.mel_filters = cfg, generate_mel_filters()
    j.tokenizer = BPETokenizer(make_byte_vocab(cfg.decoder.vocab_size, {}), [])
    j.params = jax.tree.map(jnp.asarray, dense)
    t = port_model(cfg, dense)
    assert not j.quantize and not t.quantize
    assert j._cache_dtype() == jnp.bfloat16 and t.cache_dtype == torch.bfloat16
    assert "mega" not in t.params["decoder"] and "lm_head_q8" not in t.params["decoder"]
    for quantize in ("auto", "int4"):
        j.quantize, t.quantize = quantize, quantize
        assert j._resolve_quantize() == t._resolve_quantize(dense["decoder"])
    j.quantize, t.quantize = False, ""
    assert (Qwen3ASR(kv_int8=True, device="cpu").kv_cache, JaxASR(kv_int8=True)._cache_dtype()) \
        == ("int8", jnp.int8)
    assert Qwen3ASR(kv_int8=True, kv_cache="bf16", device="cpu").kv_cache == "bf16"

    samples = pcm()
    want = j.transcribe(samples, JaxParams(max_tokens=MAX_TOKENS, print_timing=False)).tokens
    got = t.transcribe(samples, TranscribeParams(max_tokens=MAX_TOKENS, print_timing=False))
    assert got.success and len(want) == MAX_TOKENS
    first_tie_prefix(teacher_forced_logits(t, samples, want), want, got.tokens)
    assert len(set(want)) > 1


@pytest.fixture(scope="module")
def auto_pair():
    """(JAX tokens from its megakernel in interpret mode, the port's
    Qwen3ASR(quantize="auto"), the audio)."""
    from qwen3_asr_tpu.audio.mel import _mel_device, filters_t_device
    from qwen3_asr_tpu.models.encoder import _encode_jit
    from qwen3_asr_tpu.models.generate import generate_greedy
    from qwen3_asr_tpu.ops.megakernel import pack_megakernel_params
    from qwen3_asr_tpu.runtime import params as jparams
    from qwen3_asr_tpu.text.prompt import audio_start_pos, build_asr_prompt
    from qwen3_asr_tpu_torch.audio.mel import generate_mel_filters

    cfg, dense = dense_tree()
    dec = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(dense["decoder"], "int8pc")))
    dec["mega"] = pack_megakernel_params(dec, cfg.decoder, int4=False)
    samples = pcm()
    buf, n_frames = _pad_pcm(samples)
    mel = _mel_device(jnp.asarray(buf), filters_t_device(generate_mel_filters()), n_frames).T
    feats = _encode_jit(dense["encoder"], cfg.encoder, mel, n_frames)
    prompt = build_asr_prompt(int(feats.shape[0]), cfg.decoder)
    out, n_kept = generate_greedy(
        dec, cfg.decoder, jnp.asarray(prompt, jnp.int32), jnp.int32(len(prompt)), feats,
        jnp.int32(feats.shape[0]), audio_start_pos(prompt, cfg.decoder), MAX_TOKENS,
        cache_dtype=jnp.bfloat16, _force_mega_interpret=True)
    want = [int(x) for x in np.asarray(out)[:int(n_kept)]]
    return want, port_model(cfg, dense, quantize="auto"), samples


def test_auto_resolves_to_the_int8_pack(auto_pair):
    _, t, _ = auto_pair
    dec = t.params["decoder"]
    assert t.quantize == "auto" and t.cache_dtype == torch.bfloat16
    assert tmk.weight_bits(dec["mega"]) == 8 and "i8pc:q" in dec["layers"]["wqkv"]


def _auto_teacher_forced(t, samples, tokens):
    """The port's logits at every step of its auto path, fed the given
    tokens: the prefill, then the int8 pack's twin over the bf16 cache."""
    from qwen3_asr_tpu_torch.audio.mel import mel_device
    from qwen3_asr_tpu_torch.models.encoder import encode
    from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt

    dcfg, dec = t.cfg.decoder, t.params["decoder"]
    buf, n_frames = _pad_pcm(samples)
    mel = mel_device(torch.from_numpy(buf), t.filters_t, n_frames).T
    feats = encode(t.params["encoder"], t.cfg.encoder, mel, n_frames)
    prompt = build_asr_prompt(feats.shape[0], dcfg)
    off, P = audio_start_pos(prompt, dcfg), len(prompt)
    S = -(-(P + len(tokens)) // 128) * 128
    cache = tdec.init_kv_cache(dcfg, S, "cpu", torch.bfloat16)
    h0 = tdec.embed_with_audio(dec, torch.tensor(prompt), feats, feats.shape[0], off)
    h = tdec.decoder_forward(dec, dcfg, h0, cache, P)
    logits = [tdec.lm_logits(dec, dcfg, h[P - 1])]
    L, DKV = dcfg.n_layers, dcfg.n_kv_heads * dcfg.head_dim
    for i in range(1, len(tokens)):
        logits.append(tmk.mega_decode_step_ref(
            dec["mega"], dcfg, torch.tensor([tokens[i - 1]], dtype=torch.int32), P + i - 1,
            cache["k"].view(L, S, DKV), cache["v"].view(L, S, DKV), return_logits=True)[2])
    return logits


def test_auto_matches_jax_megakernel(auto_pair):
    want, t, samples = auto_pair
    got = t.transcribe(samples, TranscribeParams(max_tokens=MAX_TOKENS, fused=True,
                                                 print_timing=False))
    assert got.success and len(want) == MAX_TOKENS and len(set(want)) > 1
    first_tie_prefix(_auto_teacher_forced(t, samples, want), want, got.tokens)


@pytest.mark.parametrize("mel_bucket", [0, 200])
def test_auto_staged_equals_fused(auto_pair, mel_bucket, capsys):
    """The staged path (prompt padded to its 128-row bucket; the bucketed
    encoder at mel_bucket > 0) gives the fused path's tokens, and prints the
    reference's timing block on stderr."""
    _, t, samples = auto_pair
    fused = t.transcribe(samples, TranscribeParams(max_tokens=MAX_TOKENS, fused=True,
                                                   print_timing=False))
    staged = t.transcribe(samples, TranscribeParams(max_tokens=MAX_TOKENS,
                                                    mel_bucket=mel_bucket))
    assert staged.success and staged.tokens == fused.tokens
    assert staged.t_encode_ms > 0 and staged.t_decode_ms > 0
    err = capsys.readouterr().err
    assert "Audio encoding:" in err and f"Tokens generated: {MAX_TOKENS}" in err


def test_auto_keeps_q8_0_gguf_blocks(tmp_path):
    """quantize="auto" leaves a Q8_0 GGUF's blocks as they are (no decode
    pack, no padded Q8_0 head), as the JAX package resolves it to none."""
    from qwen3_asr_tpu.pipeline.asr import Qwen3ASR as JaxASR
    from qwen3_asr_tpu.runtime import params as jparams
    from qwen3_asr_tpu.runtime.gguf import GGML_TYPE_Q8_0
    from helpers import write_tiny_gguf

    cfg = tiny_asr_config()
    dense = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 17, jnp.float32))
    path = str(tmp_path / "q8.gguf")
    write_tiny_gguf(path, cfg, dense, vocab=make_byte_vocab(cfg.decoder.vocab_size, {}),
                    merges=[], weight_type=GGML_TYPE_Q8_0)
    t = Qwen3ASR(quantize="auto", device="cpu")
    assert t.load_model(path), t.error_msg
    j = JaxASR(quantize="auto")
    assert j.load_model(path), j.error_msg
    assert j._resolve_quantize() == "" and t._resolve_quantize(t.params["decoder"]) == ""
    dec = t.params["decoder"]
    assert "mega" not in dec and "lm_head_q8" not in dec and "q8:q" in dec["layers"]["wqkv"]
    res = t.transcribe(pcm(1.0, 4), TranscribeParams(max_tokens=4, print_timing=False))
    assert res.success and len(res.tokens) <= 4
