"""Sampled decoding (`models/generate.py`: `filter_logits`,
`sample_from_logits`, `generate_sample`) against the JAX package's rules at
the tiny config on the CPU.

jax.random's stream cannot be matched by a torch.Generator, so the port is
held to the JAX package where no draw is involved: the filters on fixed
logits against a numpy transcription of the reference's rules (temperature
clamp, top-k ties kept, the nucleus's "exclusive cumsum < top_p" with the
cutoff element kept); the support of 2,000 JAX draws equal to the port's
kept set, and the port's own 2,000 draws matching the kept softmax (chi
square below its 0.999 quantile); the greedy limits (temperature 0,
top_k = 1) equal to the greedy paths on every decode-pack cache and on the
per-layer path (Q8_0 and dense), the JAX package's greedy tokens included.
Mirrors tests/test_sampling.py:29, :41, :72, :87, :103 and :163; :127 (the
JAX package's per-setting programs) has no counterpart: the port compiles
nothing per setting.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.generate import generate_greedy as jax_greedy
from qwen3_asr_tpu.models.generate import sample_from_logits as jax_sample
from qwen3_asr_tpu.runtime import params as jparams
from qwen3_asr_tpu_torch.models import generate as tgen
from qwen3_asr_tpu_torch.models.generate import (
    INT4_KV,
    NEG,
    filter_logits,
    generate_sample,
    sample_from_logits,
)
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import port_config

N_DRAWS = 2000


def numpy_kept(logits, temperature, top_k, top_p):
    """The reference's filters in numpy: the boolean kept set."""
    x = logits.astype(np.float32) / max(np.float32(temperature), np.float32(1e-4))
    keep = np.ones(x.shape, bool)
    if 0 < top_k < x.size:
        keep &= x >= np.sort(x)[::-1][top_k - 1]
    if top_p < 1.0:
        y = np.where(keep, x, -np.inf)
        srt = np.sort(y)[::-1]
        p = np.exp(srt - srt[0])
        p /= p.sum()
        excl = np.cumsum(p) - p
        cut = srt[excl < np.float32(top_p)].min()
        keep &= y >= cut
    return keep


FIXED = np.array([3.0, 1.0, 2.0, 2.0, 0.5, 2.0, -1.0, 0.0], np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p,want", [
    (1.0, 0, 1.0, [0, 1, 2, 3, 4, 5, 6, 7]),       # no filter
    (1.0, 2, 1.0, [0, 2, 3, 5]),                   # ties with the k-th kept
    (1.0, 0, 0.5, [0, 2, 3, 5]),                   # the cutoff 2.0 and its ties kept
    (1.0, 0, 0.3, [0]),                            # p(3.0) = 0.35 >= 0.3: one
    (1.0, 4, 0.999, [0, 2, 3, 5]),
    (0.5, 0, 0.9, [0, 2, 3, 5]),
    (1e-6, 0, 0.9, [0]),                           # clamped at 1e-4: the argmax
])
def test_filter_logits_rules(temperature, top_k, top_p, want):
    got = filter_logits(torch.from_numpy(FIXED), temperature, top_k, top_p)
    kept = np.flatnonzero(got.numpy() > NEG).tolist()
    assert kept == want
    assert kept == np.flatnonzero(numpy_kept(FIXED, temperature, top_k, top_p)).tolist()
    scaled = FIXED / max(np.float32(temperature), np.float32(1e-4))
    np.testing.assert_array_equal(got.numpy()[want], scaled[want])
    assert (got.numpy()[[i for i in range(8) if i not in want]] == NEG).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_logits_random_against_numpy(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(512) * 3).astype(np.float32)
    for temperature, top_k, top_p in ((0.7, 40, 0.9), (1.3, 0, 0.8), (1.0, 511, 1.0),
                                      (0.2, 1, 0.5), (2.0, 600, 0.95)):
        got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p) > NEG
        np.testing.assert_array_equal(got.numpy(), numpy_kept(logits, temperature,
                                                              top_k, top_p))


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 0.6), (2.0, 12, 1.0),
                                                    (1.3, 20, 0.8), (1.5, 0, 0.7)])
def test_draws_cover_the_jax_support(temperature, top_k, top_p):
    """2,000 draws of the JAX package (PRNGKey(s)) and of the port (its
    Gumbel-max on uniforms from a seeded torch.Generator), V = 32: the JAX draws' support is the port's
    kept set (every kept token has a probability of at least 2.9% under
    these settings, some 59 draws expected); the port's draws stay in it and
    their counts match the kept softmax (chi square under its 0.999
    quantile)."""
    logits = (np.random.default_rng(5).standard_normal(32) * 2.5).astype(np.float32)
    lt = torch.from_numpy(logits)
    kept = np.flatnonzero(filter_logits(lt, temperature, top_k, top_p).numpy() > NEG)
    draw = jax.jit(lambda s: jax_sample(jnp.asarray(logits), jax.random.PRNGKey(s),
                                        temperature, top_k, top_p))
    jax_draws = np.array([int(draw(s)) for s in range(N_DRAWS)])
    assert set(jax_draws.tolist()) == set(kept.tolist())
    u = torch.rand(N_DRAWS, 32, generator=torch.Generator().manual_seed(1))
    ours = np.array([int(sample_from_logits(lt, u[i], temperature, top_k, top_p)[0])
                     for i in range(N_DRAWS)])
    assert set(ours.tolist()) <= set(kept.tolist())
    x = logits[kept] / np.float32(temperature)
    p = np.exp(x - x.max())
    p /= p.sum()
    counts = np.array([(ours == k).sum() for k in kept])
    chi2 = float(((counts - N_DRAWS * p) ** 2 / (N_DRAWS * p)).sum())
    assert chi2 < stats.chi2.ppf(0.999, len(kept) - 1), (chi2, counts, p)


def test_sample_greedy_limits():
    """Mirror of tests/test_sampling.py:29: temperature <= 0 is the argmax
    whatever u; top_k = 1 pins every draw to the argmax."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    want = int(torch.argmax(logits))
    u = torch.rand(16, 64, generator=torch.Generator().manual_seed(0))
    for i in range(16):
        assert int(sample_from_logits(logits, u[i], 0.0)[0]) == want
        assert int(sample_from_logits(logits, u[i], 1.7, top_k=1)[0]) == want
    # uniforms of 0 (floored at TINY) give every logit the same noise
    assert int(sample_from_logits(logits, torch.zeros(64), 1.0)[0]) == want


def test_top_p_draws_only_from_nucleus():
    """Mirror of tests/test_sampling.py:41: 50 draws at top_p 0.6 all in the
    smallest descending prefix reaching 0.6 (the cutoff element included)."""
    rng = np.random.default_rng(1)
    logits_np = rng.standard_normal(32).astype(np.float32) * 3.0
    order = np.argsort(-logits_np)
    probs = np.exp(logits_np - logits_np.max())
    probs /= probs.sum()
    cum = np.cumsum(probs[order])
    keep = set(order[:int(np.argmax(cum >= 0.6)) + 1].tolist())
    u = torch.rand(50, 32, generator=torch.Generator().manual_seed(2))
    for i in range(50):
        assert int(sample_from_logits(torch.from_numpy(logits_np), u[i], 1.0, 0, 0.6)[0]) in keep


# -- generate_sample ----------------------------------------------------------

MAX = 8


def _prompt(dcfg, rng):
    n_audio = 4
    audio = rng.standard_normal((n_audio, dcfg.hidden_size)).astype(np.float32)
    prompt = [5, 6] + [dcfg.audio_pad_token_id] * n_audio + [7]
    toks = np.zeros(16, np.int32)
    toks[:len(prompt)] = prompt
    return toks, len(prompt), audio, n_audio


@pytest.fixture(scope="module")
def dense_f32():
    """tests/test_sampling.py:58's setup: dense f32 weights (seed 13)."""
    cfg = tiny_asr_config()
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 13, jnp.float32))
    p["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(p["decoder"]))
    toks, n_prompt, audio, n_audio = _prompt(cfg.decoder, np.random.default_rng(0))
    tdec = from_jax_params(p, port_config(cfg))["decoder"]
    jargs = (jnp.asarray(toks), jnp.int32(n_prompt), jnp.asarray(audio),
             jnp.int32(n_audio), 2, MAX)
    targs = (torch.from_numpy(toks), n_prompt, torch.from_numpy(audio), n_audio, 2, MAX)
    return cfg, p["decoder"], tdec, jargs, targs


def _toks(out, n):
    return [int(t) for t in np.asarray(out)[:int(n)]]


def test_generate_sample_topk1_matches_greedy(dense_f32):
    """Mirror of tests/test_sampling.py:72 on the per-layer path (dense f32
    weights, bf16 cache): top_k = 1 at temperature 1.3 gives the greedy
    tokens, the port's and the JAX package's."""
    cfg, jd, td, jargs, targs = dense_f32
    dcfg = port_config(cfg.decoder)
    want = _toks(*jax_greedy(jd, cfg.decoder, *jargs, cache_dtype=jnp.bfloat16))
    greedy = _toks(*tgen.generate_greedy(td, dcfg, *targs))
    limit = _toks(*generate_sample(td, dcfg, *targs, seed=7, temperature=1.3, top_k=1))
    assert limit == greedy == want


def test_generate_sample_seed_determinism(dense_f32):
    """Mirror of tests/test_sampling.py:87: the same seed gives the same
    tokens, in range; another seed other tokens."""
    cfg, _, td, _, targs = dense_f32
    dcfg = port_config(cfg.decoder)

    def run(seed):
        return _toks(*generate_sample(td, dcfg, *targs, seed=seed, temperature=1.0,
                                      top_p=0.95))

    a, b = run(3), run(3)
    assert a == b and len(a) >= 1
    assert all(0 <= t < dcfg.vocab_size for t in a)
    assert run(4) != a


@pytest.fixture(scope="module")
def packed():
    """The int8 decode pack on bf16 weights (seed 13), as
    tests/test_sampling.py:103 builds it, and the int4 one."""
    cfg = tiny_asr_config()
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 13, jnp.bfloat16))
    p["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(p["decoder"], "int8pc")))
    toks, n_prompt, audio, n_audio = _prompt(cfg.decoder, np.random.default_rng(0))
    tcfg = port_config(cfg)
    decs = {w: from_jax_params(p, tcfg, int4=w == "int4")["decoder"]
            for w in ("int8", "int4")}
    targs = (torch.from_numpy(toks), n_prompt,
             torch.from_numpy(audio).to(torch.bfloat16), n_audio, 2, 6)
    jargs = (jnp.asarray(toks), jnp.int32(n_prompt), jnp.asarray(audio, jnp.bfloat16),
             jnp.int32(n_audio), 2, 6)
    return cfg, p["decoder"], decs, jargs, targs


@pytest.mark.parametrize("kv", ["int8", "bf16", "int4"])
def test_generate_sample_mega_topk1(packed, kv):
    """Mirror of tests/test_sampling.py:103 on every decode-pack cache: the
    sampled path (the twin's h_out through the int8pc lm head) at top_k = 1
    equals generate_greedy through the same twin on the int8 pack, whose
    head is that int8pc head; on the int8 cache, also the JAX package's
    megakernel in interpret mode."""
    cfg, jd, decs, jargs, targs = packed
    dcfg = port_config(cfg.decoder)
    cache = {"int8": torch.int8, "bf16": torch.bfloat16, "int4": INT4_KV}[kv]
    greedy = _toks(*tgen.generate_greedy(decs["int8"], dcfg, *targs, cache))
    limit = _toks(*generate_sample(decs["int8"], dcfg, *targs, seed=5, temperature=0.8,
                                   top_k=1, cache_dtype=cache))
    assert limit == greedy and len(limit) == 6
    if kv == "int8":
        from qwen3_asr_tpu.ops.megakernel import pack_megakernel_params

        jm = dict(jd, mega=pack_megakernel_params(jd, cfg.decoder))
        want = _toks(*jax_greedy(jm, cfg.decoder, *jargs, cache_dtype=jnp.int8,
                                 _force_mega_interpret=True))
        assert limit == want


def test_generate_sample_samples_from_h(packed, monkeypatch):
    """On a decode pack the head the sampled path applies is the tree's
    lm_logits on the step's hidden state before the final norm (the twin's
    h): each call's row equals the twin's h at that step, fed the sampled
    tokens."""
    from qwen3_asr_tpu_torch.ops.megakernel import mega_decode_step_ref

    cfg, _, decs, _, targs = packed
    dcfg = port_config(cfg.decoder)
    dec = decs["int4"]
    rows = []
    real = tgen.lm_logits

    def spy(d, c, h):
        rows.append(h.clone())
        return real(d, c, h)

    monkeypatch.setattr(tgen, "lm_logits", spy)
    out, n = generate_sample(dec, dcfg, *targs, seed=1, temperature=1.0, top_k=50,
                             cache_dtype=torch.int8)
    monkeypatch.undo()
    toks, n_prompt, audio, n_audio, off, max_tokens = targs
    S = tgen.cache_rows(toks.shape[0], max_tokens)
    h_last, cache = tgen.prefill_hidden(dec, dcfg, toks, n_prompt, audio, n_audio, off,
                                        S, torch.int8)
    kvs = tgen.mega_caches(dcfg, cache, torch.int8)
    assert torch.equal(rows[0].reshape(-1), h_last.reshape(-1))
    for i in range(1, max_tokens):
        h = mega_decode_step_ref(dec["mega"], dcfg, torch.from_numpy(out[i - 1:i]),
                                 n_prompt + i - 1, *kvs)[1]
        assert torch.equal(rows[i].reshape(-1), h.reshape(-1)), i
    assert len(rows) == max_tokens


@pytest.mark.parametrize("quantize", ["q8_0", False])
def test_per_layer_path_sampling(quantize):
    """The per-layer path (Q8_0 through the twins of K4-K7, and dense):
    top_k = 1 gives generate_greedy's tokens; a seed is reproducible."""
    cfg = tiny_asr_config()
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 13, jnp.bfloat16))
    dec = p["decoder"]
    if quantize:
        dec = jparams.quantize_decoder_params(dec, quantize)
    p["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(dec))
    td = from_jax_params(p, port_config(cfg))["decoder"]
    assert "mega" not in td
    dcfg = port_config(cfg.decoder)
    toks, n_prompt, audio, n_audio = _prompt(cfg.decoder, np.random.default_rng(0))
    targs = (torch.from_numpy(toks), n_prompt, torch.from_numpy(audio).to(torch.bfloat16),
             n_audio, 2, 6)
    greedy = _toks(*tgen.generate_greedy(td, dcfg, *targs))
    assert _toks(*generate_sample(td, dcfg, *targs, seed=2, temperature=0.5,
                                  top_k=1)) == greedy
    runs = [_toks(*generate_sample(td, dcfg, *targs, seed=9, temperature=1.0, top_k=40,
                                   top_p=0.9)) for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) >= 1


def test_eos_ends_the_sampled_loop(dense_f32):
    """An EOS drawn at step i ends the request there: n_kept = i, the
    tokens before it kept."""
    cfg, _, td, _, targs = dense_f32
    dcfg = port_config(cfg.decoder)
    free = _toks(*generate_sample(td, dcfg, *targs, seed=3, temperature=1.0))
    eos_cfg = dataclasses.replace(dcfg, eos_token_id=free[3])
    out, n = generate_sample(td, eos_cfg, *targs, seed=3, temperature=1.0)
    assert n == free.index(free[3]) and _toks(out, n) == free[:n]


def test_pipeline_temperature_param():
    """Mirror of tests/test_sampling.py:163: Qwen3ASR.transcribe honours
    temperature and seed (the same seed, the same tokens), and top_k = 1 is
    the greedy path's tokens."""
    from qwen3_asr_tpu_torch.config import tiny_asr_config as port_tiny
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

    cfg = port_tiny()
    asr = Qwen3ASR(device="cpu", dtype=torch.float32)
    asr.load_random(cfg, seed=13, vocab=[chr(33 + i % 90) for i in range(cfg.decoder.vocab_size)])
    t = np.arange(16000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    params = TranscribeParams(max_tokens=5, print_timing=False, prompt_bucket=32,
                              temperature=0.9, seed=11)
    r1, r2 = asr.transcribe(audio, params), asr.transcribe(audio, params)
    assert r1.success and r2.success and r1.tokens == r2.tokens
    greedy = asr.transcribe(audio, TranscribeParams(max_tokens=5, print_timing=False,
                                                    prompt_bucket=32))
    limit = asr.transcribe(audio, TranscribeParams(max_tokens=5, print_timing=False,
                                                   prompt_bucket=32, temperature=1.0,
                                                   top_k=1))
    assert limit.tokens == greedy.tokens
