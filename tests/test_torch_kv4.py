"""The int4 KV cache: the port's `pack_kv_int4` and K1's int4 step (the
twin, `mega_decode_step_i4` on a CPU tensor) against the JAX package's
(`mega_decode_step_i4` in interpret mode), generation over the int4 cache
against the JAX package's `generate_greedy(cache_dtype=jnp.int4)`, and the
int4 cache without a decode pack, which runs as int8. The CUDA kernel vs
the twin: tests/test_torch_cuda.py.

Bounds, on the tiny config's cache rows (32 entries of one layer):
- `pack_kv_int4`: codes and scales bit-equal.
- One step from the same cache: the token equal; h relative L2 < 2e-2, as
  tests/test_torch_megakernel.py holds every cache mode; layer 0's fresh
  codes equal (its input is the same embedding row in both) and its scales
  within 2.5e-7 relative (two f32 ulps: the RMS sums run in another
  order). From layer 1 on, the interpret-mode kernel's inputs carry XLA's
  excess precision (tests/test_torch_megakernel.py), so a code may land
  one step away where x / s sits near a rounding tie, on at most 2 of a
  layer's 32 K or V codes, and the scales are held at rtol 2e-2 (1.2e-2
  seen). The byte rows other than pos // 2, and the other nibble of
  pos // 2, are untouched, at an even and an odd pos.
- Each layer alone on the JAX kernel's own input row: codes equal but on at
  most 1 of 32 (a rounding tie), h relative L2 < 1e-2.
- Generation: teacher-forced on the JAX tokens, each port argmax equals the
  JAX token or trails it by at most NEAR_TIE_TOL; the free-running tokens
  equal up to the first such tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.decoder import _quantize_kv_rows
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu_torch.models import generate as tgen
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_auto import first_tie_prefix
from test_torch_params import jax_tree, port_config

S = 32
PACKS = {"int4": True, "int8": False}
GAIN = 6


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=3)
    megas = {w: jmk.pack_megakernel_params(tree["decoder"], cfg.decoder, int4=i4)
             for w, i4 in PACKS.items()}
    packs = {w: from_jax_params(tree, port_config(cfg), int4=i4)["decoder"]["mega"]
             for w, i4 in PACKS.items()}
    return cfg.decoder, tree, megas, packs


def int8_rows(dcfg, n: int, seed: int, S: int = S):
    """An int8 cache [L, S, DKV] and its scales [L, S, NKV] (numpy), rows < n
    drawn from N(0, 0.25) and quantized as the prefill quantizes them."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    rows = np.random.default_rng(seed).standard_normal((L, n, NKV, D)).astype(np.float32)
    q, s = jax.jit(_quantize_kv_rows)(jnp.asarray(rows * 0.5))
    k = np.zeros((L, S, NKV * D), np.int8)
    ks = np.zeros((L, S, NKV), np.float32)
    k[:, :n] = np.asarray(q).reshape(L, n, NKV * D)
    ks[:, :n] = np.asarray(s)
    return k, ks


def int4_cache(dcfg, n: int, seed: int, S: int = S):
    """(packed uint8 [L, S/2, DKV], scales [L, S, NKV]) as numpy, from the JAX
    package's pack_kv_int4."""
    k4, s4 = jmk.pack_kv_int4(*map(jnp.asarray, int8_rows(dcfg, n, seed, S)))
    return np.asarray(k4).view(np.uint8).copy(), np.asarray(s4).copy()


def codes(b: np.ndarray, pos: int) -> np.ndarray:
    """Cache row pos of every layer as int codes [L, DKV], from uint8 pairs."""
    n = (b[:, pos // 2] >> (4 * (pos % 2))) & 0xF
    return n.astype(np.int64) - 16 * (n >= 8)


def jax_i4_step(mega, dcfg, x, pos, k, v, ks, vs):
    """One JAX int4 step on numpy caches -> (token, h, k, v, ks, vs) as numpy
    (bytes uint8, scales back in [L, S, NKV])."""
    tok, k, v, ks, vs, h = jmk.mega_decode_step_i4(
        mega, dcfg, jnp.asarray(x), jnp.int32(pos), jnp.asarray(k.view(np.int8)),
        jnp.asarray(v.view(np.int8)), jnp.asarray(ks.transpose(0, 2, 1)),
        jnp.asarray(vs.transpose(0, 2, 1)), interpret=True)
    return (int(tok), np.asarray(h), np.asarray(k).view(np.uint8),
            np.asarray(v).view(np.uint8), np.asarray(ks).transpose(0, 2, 1),
            np.asarray(vs).transpose(0, 2, 1))


def port_i4_step(pack, dcfg, tok_or_x, pos, k, v, ks, vs):
    """One port twin step on copies of numpy caches -> (token, h, k, v, ks,
    vs) as numpy."""
    c = [torch.from_numpy(a.copy()) for a in (k, v, ks, vs)]
    tok, h = tmk.mega_decode_step_i4(pack, port_config(dcfg), tok_or_x, pos, *c)
    return (int(tok[0]), h.numpy(), *(t.numpy() for t in c))


def test_pack_kv_int4_bit_equal():
    """Codes clip(round(q * 7/127), -7, 7) nibble-packed (row 2r low) and
    scales * 127/7: bit-equal to the JAX package's, and unpack_nibbles
    gives the codes back."""
    rng = np.random.default_rng(0)
    kq = rng.integers(-127, 128, (2, 16, 32)).astype(np.int8)
    s8 = (rng.random((2, 16, 2)) * 0.01 + 1e-3).astype(np.float32)
    jk, js = jmk.pack_kv_int4(jnp.asarray(kq), jnp.asarray(s8))
    tk, ts = tmk.pack_kv_int4(torch.from_numpy(kq), torch.from_numpy(s8))
    assert tk.dtype == torch.uint8 and tuple(tk.shape) == (2, 8, 32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.clip(np.round(kq.astype(np.float32) * np.float32(7 / 127)), -7, 7)
    np.testing.assert_array_equal(tmk.unpack_nibbles(tk).numpy(), want.astype(np.int8))


@pytest.mark.parametrize("pos", [18, 19])
@pytest.mark.parametrize("weights", list(PACKS))
def test_i4_step_matches_jax(setup, weights, pos):
    dcfg, tree, megas, packs = setup
    k, ks = int4_cache(dcfg, pos, 1)
    v, vs = int4_cache(dcfg, pos, 2)
    x = tree["decoder"]["token_embd"][7][None]
    jt, jh, jk, jv, jks, jvs = jax_i4_step(megas[weights], dcfg, x, pos, k, v, ks, vs)
    tt, th, tk, tv, tks, tvs = port_i4_step(packs[weights], dcfg,
                                            torch.tensor([7], dtype=torch.int32), pos,
                                            k, v, ks, vs)
    assert tt == jt
    assert np.linalg.norm(th - jh) / np.linalg.norm(jh) < 2e-2
    for got, want, gs, ws, orig in ((tk, jk, tks, jks, k), (tv, jv, tvs, jvs, v)):
        d = np.abs(codes(got, pos) - codes(want, pos))
        assert not d[0].any() and d.max() <= 1 and (d > 0).sum(axis=1).max() <= 2
        np.testing.assert_allclose(gs[0, pos], ws[0, pos], rtol=2.5e-7)
        np.testing.assert_allclose(gs[:, pos], ws[:, pos], rtol=2e-2)
        # the other nibble of byte row pos // 2 and every other byte row kept
        keep = 0xF0 if pos % 2 == 0 else 0x0F
        np.testing.assert_array_equal(got[:, pos // 2] & keep, orig[:, pos // 2] & keep)
        np.testing.assert_array_equal(np.delete(got, pos // 2, axis=1),
                                      np.delete(orig, pos // 2, axis=1))
        np.testing.assert_array_equal(want[0], got[0])


@pytest.mark.parametrize("weights", list(PACKS))
def test_i4_layers_match_jax(setup, weights):
    """Each layer alone (one-layer packs) on the JAX kernel's hidden state
    at pos 19 (the high nibble)."""
    from test_torch_megakernel import _JAX_LAYER_KEYS, _PORT_LAYER_KEYS

    dcfg, tree, megas, packs = setup
    dcfg1 = dataclasses.replace(dcfg, n_layers=1)
    pos = 19
    k, ks = int4_cache(dcfg, pos, 3)
    v, vs = int4_cache(dcfg, pos, 4)
    x = tree["decoder"]["token_embd"][7][None]
    for l in range(dcfg.n_layers):
        jm = {n: (a[l:l + 1] if n in _JAX_LAYER_KEYS else a) for n, a in megas[weights].items()}
        tm = {n: (a[l:l + 1] if n in _PORT_LAYER_KEYS else a) for n, a in packs[weights].items()}
        one = [a[l:l + 1] for a in (k, v, ks, vs)]
        _, jh, jk, jv, jks, jvs = jax_i4_step(jm, dcfg1, x, pos, *one)
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        _, th, tk, tv, tks, tvs = port_i4_step(tm, dcfg1, xt, pos, *one)
        assert np.linalg.norm(th - jh) / np.linalg.norm(jh) < 1e-2, l
        for got, want in ((tk, jk), (tv, jv)):
            assert (codes(got, pos) != codes(want, pos)).sum() <= 1, l
        np.testing.assert_allclose(tks[:, pos], jks[:, pos], rtol=2e-2)
        x = jh.astype(jnp.bfloat16)


def wide_decoder(seed=7, gain=GAIN, eos=None):
    """(JAX decoder config, the JAX decoder tree as numpy with the decode
    pack of each weight kind) with the decoder's matrices `gain` times
    wider than the package's init, so the layers decide the tokens."""
    from qwen3_asr_tpu.runtime import params as jparams

    cfg = tiny_asr_config()
    dcfg = cfg.decoder if eos is None else dataclasses.replace(cfg.decoder, eos_token_id=eos)
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, seed, jnp.bfloat16))
    lay = p["decoder"]["layers"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        lay[k] = (lay[k].astype(np.float32) * gain).astype(lay[k].dtype)
    dec = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(p["decoder"], "int8pc")))
    return dcfg, p, dec


def prompt_tokens(dcfg, seed=3, n=12, P=16):
    toks = np.zeros(P, np.int32)
    toks[:n] = np.random.default_rng(seed).integers(1, 200, size=n)
    return toks, n


def teacher_forced_logits(dec, dcfg, toks, n_prompt, tokens, cache_dtype):
    """The port's logits at each step of its decode-pack path over the given
    cache, fed `tokens`: the prefill, then the twin step per token."""
    from qwen3_asr_tpu_torch.models import decoder as tdm

    S = tgen.cache_rows(len(toks), len(tokens))
    cache = tdm.init_kv_cache(dcfg, S, "cpu",
                              torch.int8 if cache_dtype == tgen.INT4_KV else cache_dtype)
    h0 = tdm.embed_with_audio(dec, torch.from_numpy(toks), None, 0, 0)
    h = tdm.decoder_forward(dec, dcfg, h0, cache, n_prompt)
    logits = [tdm.lm_logits(dec, dcfg, h[n_prompt - 1])]
    kvs = tgen.mega_caches(dcfg, cache, cache_dtype)
    for i in range(1, len(tokens)):
        logits.append(tmk.mega_decode_step_ref(
            dec["mega"], dcfg, torch.tensor([tokens[i - 1]], dtype=torch.int32),
            n_prompt + i - 1, *kvs, return_logits=True)[2])
    return logits


@pytest.mark.parametrize("weights", list(PACKS))
def test_generate_int4_matches_jax(weights):
    from qwen3_asr_tpu.models.generate import generate_greedy as jax_generate

    dcfg, p, dec = wide_decoder(eos=-1)
    jdec = dict(dec, mega=jmk.pack_megakernel_params(dec, dcfg, int4=PACKS[weights]))
    tcfg = port_config(tiny_asr_config())
    tdec = from_jax_params(dict(p, decoder=dec), tcfg, int4=PACKS[weights])["decoder"]
    tdcfg = dataclasses.replace(tcfg.decoder, eos_token_id=-1)
    toks, n = prompt_tokens(dcfg)
    max_tokens = 8
    out, n_kept = jax_generate(jdec, dcfg, jnp.asarray(toks), jnp.int32(n), None,
                               jnp.int32(0), 0, max_tokens, cache_dtype=jnp.int4,
                               _force_mega_interpret=True)
    want = [int(t) for t in np.asarray(out)[:int(n_kept)]]
    got, kept = tgen.generate_greedy(tdec, tdcfg, torch.from_numpy(toks), n, None, 0, 0,
                                     max_tokens, tgen.INT4_KV)
    assert len(want) == max_tokens and kept == max_tokens and len(set(want)) > 1
    first_tie_prefix(teacher_forced_logits(tdec, tdcfg, toks, n, want, tgen.INT4_KV),
                     want, [int(t) for t in got[:kept]])


@pytest.mark.parametrize("quantize", ["q8_0", False])
def test_int4_cache_without_pack_runs_int8(quantize):
    """With no decode pack (q8_0, dense) the int4 cache runs as int8, as the
    JAX package's generate_greedy does: the same tokens as kv_cache="int8",
    through an int8 prefill cache."""
    from qwen3_asr_tpu_torch.config import tiny_asr_config as port_tiny
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from test_torch_q8_e2e import pcm

    a = Qwen3ASR(quantize=quantize, kv_cache="int4", device="cpu")
    a.load_random(port_tiny(), seed=5)
    b = Qwen3ASR(quantize=quantize, kv_cache="int8", device="cpu")
    b.cfg, b.params, b.tokenizer, b.filters_t = a.cfg, a.params, a.tokenizer, a.filters_t
    assert a.cache_dtype == tgen.INT4_KV and "mega" not in a.params["decoder"]
    assert tgen.kv_dtype(a.params["decoder"], a.cache_dtype) == torch.int8
    params = TranscribeParams(max_tokens=6, fused=True, print_timing=False)
    got, want = a.transcribe(pcm(1.0), params), b.transcribe(pcm(1.0), params)
    assert got.success and got.tokens == want.tokens
