"""The streaming decode path (`generate_greedy_streaming`, the `decode_chunk*`
functions, `Qwen3ASR`'s progress and token callbacks) on the CPU, mirroring
tests/test_streaming.py:

- in every mode (the int4 and int8 decode packs over a bf16, int8 or int4
  cache; Q8_0 and dense weights on the per-layer step, the int4 cache there
  running as int8) the port's streaming tokens are exactly its
  generate_greedy tokens, with and without an EOS inside a chunk, and it
  calls on_token(i, max_tokens) and on_token_id(t) once per token;
- against the JAX package's generate_greedy_streaming (the megakernel in
  interpret mode, `_force_mega_interpret=True`; its XLA step for Q8_0):
  teacher-forced on the JAX tokens, each port argmax equals the JAX token
  or trails it by at most NEAR_TIE_TOL, and the free-running tokens equal
  up to the first such tie;
- the callbacks match the JAX package's call for call at chunk sizes 1, 3
  and 8, stopping at an EOS inside a chunk and at the budget;
- `Qwen3ASR.set_progress_callback` / `set_token_callback` / print_progress
  take the streaming path and give the tokens of the path without them.

The decoder's matrices are drawn GAIN times wider than the package's init
(tests/test_torch_kv4.py::wide_decoder) so the layers decide the tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu_torch.models import decoder as tdm
from qwen3_asr_tpu_torch.models import generate as tgen
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_auto import first_tie_prefix
from test_torch_kv4 import prompt_tokens, teacher_forced_logits, wide_decoder
from test_torch_params import port_config

CACHE = {"bf16": torch.bfloat16, "int8": torch.int8, "int4": tgen.INT4_KV}
JCACHE = {"bf16": jnp.bfloat16, "int8": jnp.int8, "int4": jnp.int4}
MODES = [(w, kv) for w in ("int4", "int8") for kv in CACHE] + [
    ("q8_0", "bf16"), ("q8_0", "int8"), ("q8_0", "int4"), ("dense", "bf16")]
MAX_TOKENS = 8


@pytest.fixture(scope="module")
def trees():
    """{weights: (JAX decoder tree, the port's decoder tree)} on the wide
    init, and the JAX decoder config (EOS inside the vocab)."""
    from qwen3_asr_tpu.runtime import params as jparams

    dcfg, p, dec8 = wide_decoder()
    tcfg = port_config(tiny_asr_config())
    out = {}
    for w in ("int4", "int8"):
        jdec = dict(dec8, mega=jmk.pack_megakernel_params(dec8, dcfg, int4=w == "int4"))
        out[w] = (jdec, from_jax_params(dict(p, decoder=dec8), tcfg, int4=w == "int4")["decoder"])
    for w, q in (("q8_0", "q8_0"), ("dense", None)):
        dec = p["decoder"] if q is None else jparams.quantize_decoder_params(p["decoder"], q)
        jdec = jax.tree.map(np.asarray, jparams.fuse_decoder_params(dec))
        out[w] = (jdec, from_jax_params(dict(p, decoder=jdec), tcfg)["decoder"])
    return out, dcfg


def tcfg_of(dcfg, eos=None):
    c = port_config(dcfg)
    return c if eos is None else dataclasses.replace(c, eos_token_id=eos)


def port_stream(dec, dcfg, toks, n, kv, max_tokens=MAX_TOKENS, chunk=tgen.STREAM_CHUNK):
    """The port's streaming tokens and its (on_token, on_token_id) calls."""
    progress, ids = [], []
    out = tgen.generate_greedy_streaming(
        dec, dcfg, torch.from_numpy(toks), n, None, 0, 0, max_tokens,
        on_token=lambda i, total: progress.append((i, total)), cache_dtype=CACHE[kv],
        chunk=chunk, on_token_id=ids.append)
    return out, progress, ids


def jax_stream(dec, dcfg, toks, n, kv, max_tokens=MAX_TOKENS, chunk=8):
    from qwen3_asr_tpu.models.generate import generate_greedy_streaming

    progress, ids = [], []
    out = generate_greedy_streaming(
        dec, dcfg, jnp.asarray(toks), jnp.int32(n), None, jnp.int32(0), 0, max_tokens,
        on_token=lambda i, total: progress.append((i, total)), cache_dtype=JCACHE[kv],
        chunk=chunk, on_token_id=ids.append, _force_mega_interpret="mega" in dec)
    return out, progress, ids


def port_logits(dec, dcfg, toks, n, tokens, kv):
    """The port's teacher-forced logits on its path for this tree and cache."""
    cache_dtype = tgen.kv_dtype(dec, CACHE[kv])
    if "mega" in dec:
        return teacher_forced_logits(dec, dcfg, toks, n, tokens, cache_dtype)
    S = tgen.cache_rows(len(toks), len(tokens))
    cache = tdm.init_kv_cache(dcfg, S, "cpu", cache_dtype)
    h = tdm.decoder_forward(dec, dcfg, tdm.embed_with_audio(dec, torch.from_numpy(toks),
                                                            None, 0, 0), cache, n)
    logits = [tdm.lm_logits(dec, dcfg, h[n - 1])]
    for i in range(1, len(tokens)):
        buf = torch.tensor([tokens[i - 1], 0], dtype=torch.int32)
        logits.append(tgen.decode_token(dec, dcfg, cache, buf, 1, n + i - 1))
    return logits


@pytest.mark.parametrize("weights,kv", MODES)
def test_streaming_equals_generate_greedy(trees, weights, kv):
    """Chunk 3 (so chunks end inside the budget), EOS off and EOS set to the
    free run's 5th token: the same tokens as generate_greedy, one on_token
    and one on_token_id call per token."""
    (_, dec), dcfg = trees[0][weights], trees[1]
    toks, n = prompt_tokens(dcfg)
    free = None
    for eos in (-1, "fifth"):
        cfg = tcfg_of(dcfg, free[4] if eos == "fifth" else eos)
        out, kept = tgen.generate_greedy(dec, cfg, torch.from_numpy(toks), n, None, 0, 0,
                                         MAX_TOKENS, CACHE[kv])
        want = [int(t) for t in out[:kept]]
        got, progress, ids = port_stream(dec, cfg, toks, n, kv, chunk=3)
        assert got == want and ids == want
        assert progress == [(i + 1, MAX_TOKENS) for i in range(len(want))]
        free = free or want
    assert len(free) == MAX_TOKENS and len(set(free)) > 1
    assert len(want) == free.index(free[4]) < MAX_TOKENS


@pytest.mark.parametrize("weights,kv", [("int8", "bf16"), ("int8", "int8"), ("int8", "int4"),
                                        ("int4", "int8"), ("q8_0", "bf16")])
def test_streaming_matches_jax(trees, weights, kv):
    (jdec, dec), dcfg = trees[0][weights], trees[1]
    toks, n = prompt_tokens(dcfg)
    cfg = dataclasses.replace(dcfg, eos_token_id=-1)
    want = [int(t) for t in jax_stream(jdec, cfg, toks, n, kv)[0]]
    got = port_stream(dec, tcfg_of(dcfg, -1), toks, n, kv)[0]
    assert len(want) == MAX_TOKENS and len(set(want)) > 1
    first_tie_prefix(port_logits(dec, tcfg_of(dcfg, -1), toks, n, want, kv), want, got)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_streaming_callbacks_match_jax(trees, chunk):
    """The int4 pack over the int4 cache: with EOS at the free run's 6th
    token (a stop inside a chunk but at chunk 1) and with a budget of 5
    tokens, the tokens and the on_token / on_token_id calls equal the JAX
    package's."""
    (jdec, dec), dcfg = trees[0]["int4"], trees[1]
    toks, n = prompt_tokens(dcfg)
    free = jax_stream(jdec, dataclasses.replace(dcfg, eos_token_id=-1), toks, n, "int4",
                      chunk=chunk)[0]
    assert len(free) == MAX_TOKENS and free[5] not in free[:5]
    for eos, budget in ((free[5], MAX_TOKENS), (-1, 5)):
        want = jax_stream(jdec, dataclasses.replace(dcfg, eos_token_id=eos), toks, n,
                          "int4", max_tokens=budget, chunk=chunk)
        got = port_stream(dec, tcfg_of(dcfg, eos), toks, n, "int4", max_tokens=budget,
                          chunk=chunk)
        assert got == want and len(got[0]) == 5


def test_chunk_functions_stop_after_eos(trees):
    """decode_chunk / decode_chunk_mega_i4 return (successors, n_generated):
    n counts the steps up to and with the first EOS, successors after it
    are zeros, and a limit below n_steps leaves the rest zero."""
    (_, dec), dcfg = trees[0]["int4"], trees[1]
    toks, n = prompt_tokens(dcfg)
    free = port_stream(dec, tcfg_of(dcfg, -1), toks, n, "int4")[0]
    cfg = tcfg_of(dcfg, free[3])
    S = tgen.cache_rows(len(toks), MAX_TOKENS)
    first, cache = tgen.prefill(dec, cfg, torch.from_numpy(toks), n, None, 0, 0, S,
                                tgen.INT4_KV)
    succ, got = tgen.decode_chunk_mega_i4(dec, cfg, first, n,
                                          *tgen.mega_caches(cfg, cache, tgen.INT4_KV), 8, 6)
    assert got == 3 and list(succ) == free[1:4] + [0] * 5
    (_, qdec) = trees[0]["q8_0"]
    first, cache = tgen.prefill(qdec, cfg, torch.from_numpy(toks), n, None, 0, 0, S,
                                torch.bfloat16)
    succ, got = tgen.decode_chunk(qdec, tcfg_of(dcfg, -1), first, n, cache, 8, 2)
    assert got == 2 and not succ[2:].any()


def test_pipeline_callbacks_take_the_streaming_path(capsys):
    """Qwen3ASR (int4 pack, int4 cache, EOS off): a progress callback, a
    token callback and print_progress each route transcribe() through the
    streaming path, fused or not, and give the tokens of the path without
    them; print_progress writes "Generated 10 tokens..." on stderr."""
    from test_torch_batch import GAIN, jax_and_port
    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from test_torch_q8_e2e import pcm

    t = jax_and_port(gain=GAIN)[1]
    t.kv_cache = "int4"
    t.cfg = dataclasses.replace(t.cfg, decoder=dataclasses.replace(t.cfg.decoder,
                                                                   eos_token_id=-1))
    samples = pcm(1.0)
    base = t.transcribe(samples, TranscribeParams(max_tokens=12, fused=True,
                                                  print_timing=False)).tokens
    calls, ids = [], []
    t.set_progress_callback(lambda i, total: calls.append((i, total)))
    t.set_token_callback(ids.append)
    try:
        got = t.transcribe(samples, TranscribeParams(max_tokens=12, fused=True,
                                                     print_timing=False))
    finally:
        t.set_progress_callback(None)
        t.set_token_callback(None)
    assert got.success and got.tokens == base and ids == base and len(base) == 12
    assert calls == [(i + 1, 12) for i in range(12)]
    capsys.readouterr()
    shown = t.transcribe(samples, TranscribeParams(max_tokens=12, print_progress=True))
    err = capsys.readouterr().err
    assert shown.tokens == base and "Generated 10 tokens..." in err
    assert "Generated 20" not in err and "Tokens generated: 12" in err
