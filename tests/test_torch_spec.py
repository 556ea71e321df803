"""Greedy self-speculation (`models/generate.py::generate_greedy_spec`) and
the block decode it verifies with (`decoder_forward(prefill=False)` at T >=
1 rows, any cache offset), the port against the JAX package at the tiny
config on the CPU.

Spec: the port's twin drafts (the decode pack's int8-cache step) and its
plain verify pass against JAX's `generate_greedy_spec(..., interpret=True)`
(the Pallas megakernel in interpret mode) on the same fused int8pc weights,
mirroring tests/test_spec.py:49, :63 and :86: tokens, n_kept and the
{rounds, drafted, accepted} stats equal, and the tokens equal to both
packages' per-layer int8 greedy sequence. The decoder's matrices are drawn
GAIN times wider (tests/test_torch_batch.py), so the layers, not the
embedding, choose the tokens; seed 7 has no top-two logit gap under 0.015
on these 12 steps, far above the packages' rounding differences (seed 3
has a 0.0009 tie, where the port's block of k rows and its single row
round to different tokens). Not mirrored: tests/test_spec.py:97 and :126
(the port runs spec on the CPU twin, and has no long-audio demotion).

Block decode: each leaf kind (dense, Q8_0, int8pc) over an int8 and a bf16
cache, T in {1, 3, 8} rows at cache offset 11 of 32, the last row padding
(kv_valid_len = offset + T - 1) where T > 1, against JAX's
decoder_forward(prefill=False) on the same cache and input block. The JAX
CPU program keeps some bf16 intermediates in f32 (tests/test_torch_decoder.py),
so the hidden states agree to relative L2 < 1e-2, and the written cache
rows, dequantized, to relative L2 < 1e-2 per layer; every row outside
offset .. offset + T - 1 is left bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu.models.generate import generate_greedy as jax_greedy
from qwen3_asr_tpu.models.generate import generate_greedy_spec as jax_spec
from qwen3_asr_tpu.ops.megakernel import pack_megakernel_params
from qwen3_asr_tpu.runtime import params as jparams
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.models import generate as tgen
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_batch import GAIN
from test_torch_params import jax_tree, port_config

MAX = 12
SEED = 7


def _wide_tree(seed=SEED, gain=GAIN):
    cfg = tiny_asr_config()
    p = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, seed, jnp.bfloat16))
    lay = p["decoder"]["layers"]
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        lay[k] = (lay[k].astype(np.float32) * gain).astype(lay[k].dtype)
    p["decoder"] = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(p["decoder"], "int8pc")))
    return cfg, p


@pytest.fixture(scope="module")
def setup():
    cfg, p = _wide_tree()
    dcfg = cfg.decoder
    rng = np.random.default_rng(7)
    n_audio = 4
    audio = rng.standard_normal((n_audio, dcfg.hidden_size)).astype(np.float32)
    prompt = [5, 6] + [dcfg.audio_pad_token_id] * n_audio + [7]
    toks = np.zeros(16, np.int32)
    toks[:len(prompt)] = prompt
    jargs = (jnp.asarray(toks), jnp.int32(len(prompt)), jnp.asarray(audio),
             jnp.int32(n_audio), 2, MAX)
    targs = (torch.from_numpy(toks), len(prompt),
             torch.from_numpy(audio).to(torch.bfloat16), n_audio, 2, MAX)
    out, n = jax_greedy(p["decoder"], dcfg, *jargs, cache_dtype=jnp.int8)
    base = [int(t) for t in np.asarray(out)[:int(n)]]
    return cfg, p, jargs, targs, base


def _pair(cfg, p, int4=True):
    """(JAX decoder with its decode pack, the port's decoder with its own)."""
    jd = dict(p["decoder"])
    jd["mega"] = pack_megakernel_params(jd, cfg.decoder, int4=int4)
    td = from_jax_params(p, port_config(cfg), int4=int4)["decoder"]
    return jd, td


def _tokens(out, n):
    return [int(t) for t in np.asarray(out)[:int(n)]]


def _stats(st):
    return {k: int(v) for k, v in st.items()}


def test_port_int8pc_greedy_matches_jax(setup):
    """The sequence spec must emit: the port's per-layer greedy loop over
    the int8pc leaves and an int8 cache (the block decode at T = 1) equals
    the JAX package's XLA int8 greedy sequence."""
    cfg, p, _, targs, base = setup
    td = from_jax_params(p, port_config(cfg))["decoder"]
    vparams = {k: v for k, v in td.items() if k != "mega"}
    out, n = tgen.generate_greedy(vparams, port_config(cfg.decoder), *targs, torch.int8)
    assert _tokens(out, n) == base and len(base) == MAX
    assert len(set(base)) > 3   # the layers choose the tokens, not one constant


@pytest.mark.parametrize("k", [1, 3, 8])
def test_spec_matches_jax(setup, k):
    cfg, p, jargs, targs, base = setup
    jd, td = _pair(cfg, p)
    jo, jn, js = jax_spec(jd, cfg.decoder, *jargs, k=k, interpret=True)
    to, tn, ts = tgen.generate_greedy_spec(td, port_config(cfg.decoder), *targs, k=k)
    assert _tokens(to, tn) == _tokens(jo, jn) == base, (k, ts)
    assert ts == _stats(js)
    assert ts["accepted"] >= ts["rounds"] and ts["drafted"] == k * ts["rounds"]


def test_spec_exact_under_corrupted_drafts(setup):
    """Every int8 weight of the int8 decode pack sign-flipped in both
    packages: the drafts are wrong, every round keeps the one corrected
    token, and the tokens still equal the greedy sequence."""
    cfg, p, jargs, targs, base = setup
    jd, td = _pair(cfg, p, int4=False)
    jd["mega"] = {k: (-np.asarray(v)).astype(np.int8)
                  if getattr(v, "dtype", None) == jnp.int8 and v.ndim >= 2 else v
                  for k, v in jd["mega"].items()}
    td["mega"] = {k: -v if v.dtype == torch.int8 and v.dim() >= 2 else v
                  for k, v in td["mega"].items()}
    jo, jn, js = jax_spec(jd, cfg.decoder, *jargs, k=4, interpret=True)
    to, tn, ts = tgen.generate_greedy_spec(td, port_config(cfg.decoder), *targs, k=4)
    assert _tokens(to, tn) == _tokens(jo, jn) == base
    assert ts == _stats(js)
    assert ts["accepted"] == ts["rounds"] == MAX - 1


def test_spec_eos_immediately(setup):
    """EOS as the first token: both packages keep no token and run no
    round."""
    cfg, p, jargs, targs, base = setup
    eos_cfg = dataclasses.replace(cfg.decoder, eos_token_id=base[0])
    jd, td = _pair(cfg, p)
    _, jn, js = jax_spec(jd, eos_cfg, *jargs, k=4, interpret=True)
    _, tn, ts = tgen.generate_greedy_spec(td, port_config(eos_cfg), *targs, k=4)
    assert int(jn) == tn == 0
    assert ts == _stats(js) == {"rounds": 0, "drafted": 0, "accepted": 0}


def test_spec_eos_and_budget_inside_a_round(setup):
    """EOS met inside a round and the max_tokens clip: n_kept stops before
    the EOS (or at the budget) as the JAX package's does, stats equal."""
    cfg, p, jargs, targs, base = setup
    jd, td = _pair(cfg, p)
    eos_cfg = dataclasses.replace(cfg.decoder, eos_token_id=base[5])
    for dcfg, args_j, args_t in ((eos_cfg, jargs, targs),
                                 (cfg.decoder, jargs[:-1] + (7,), targs[:-1] + (7,))):
        jo, jn, js = jax_spec(jd, dcfg, *args_j, k=4, interpret=True)
        to, tn, ts = tgen.generate_greedy_spec(td, port_config(dcfg), *args_t, k=4)
        assert _tokens(to, tn) == _tokens(jo, jn) and ts == _stats(js)
        assert tn == (base.index(base[5]) if dcfg is eos_cfg else 7)
        assert to.shape == (args_t[-1],)


def test_spec_needs_the_decode_pack(setup):
    cfg, p, _, targs, _ = setup
    td = from_jax_params(p, port_config(cfg))["decoder"]
    td.pop("mega")
    with pytest.raises(ValueError, match="decode pack"):
        tgen.generate_greedy_spec(td, port_config(cfg.decoder), *targs, k=2)


# -- the block decode ---------------------------------------------------------

S, OFFSET = 32, 11
LEAVES = ("dense", "q8_0", "int8pc")


@pytest.fixture(scope="module")
def trees():
    """{leaf kind: (JAX fused decoder, port decoder)} on one seed."""
    cfg = tiny_asr_config()
    tcfg = port_config(cfg)
    dense = jax_tree(cfg, seed=5, quantize=False)
    out = {}
    for kind in LEAVES:
        dec = dense["decoder"]
        if kind != "dense":
            dec = jparams.quantize_decoder_params(dec, kind)
        dec = jax.tree.map(np.asarray, jparams.fuse_decoder_params(dec))
        tree = dict(dense, decoder=dec)
        td = from_jax_params(tree, tcfg)["decoder"]
        td.pop("mega", None)
        out[kind] = (dec, td)
    return cfg.decoder, out


def _cache(dcfg, kv, seed=1):
    """Rows < OFFSET filled, the rest holding other values (a draft's
    rows): (JAX cache, port cache)."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    rng = np.random.default_rng(seed)
    rows = {n: rng.standard_normal((L, S, NKV, D)).astype(np.float32) * 0.5
            for n in ("k", "v")}
    if kv == "bf16":
        j = {n: jnp.asarray(r, jnp.bfloat16) for n, r in rows.items()}
        t = {n: torch.from_numpy(r).to(torch.bfloat16) for n, r in rows.items()}
        return j, t
    j, t = {}, {}
    for n, r in rows.items():
        q, s = jax.jit(jdec._quantize_kv_rows)(jnp.asarray(r))
        j[n], j[n + "_s"] = q, s
        t[n], t[n + "_s"] = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    return j, t


def _rows(c, name, lo, hi):
    """Cache rows lo .. hi - 1 of every layer as f32, dequantized."""
    x = np.asarray(c[name], np.float32)[:, lo:hi] if not isinstance(c[name], torch.Tensor) \
        else c[name][:, lo:hi].float().numpy()
    if name + "_s" in c:
        s = c[name + "_s"]
        s = s[:, lo:hi].numpy() if isinstance(s, torch.Tensor) else np.asarray(s)[:, lo:hi]
        x = x * s[..., None]
    return x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("kind", LEAVES)
def test_block_decode_matches_jax(trees, kind, kv, T):
    dcfg, by_kind = trees
    jd, td = by_kind[kind]
    tcfg = port_config(dcfg)
    valid = OFFSET + T - (1 if T > 1 else 0)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, dcfg.hidden_size)).astype(np.float32) * 0.1
    jc, tc = _cache(dcfg, kv)
    before = {n: v.clone() for n, v in tc.items()}
    hj, jc2 = jdec.decoder_forward(
        jd, dcfg, jnp.asarray(x, jnp.bfloat16),
        jnp.arange(OFFSET, OFFSET + T, dtype=jnp.int32), jc,
        cache_offset=jnp.int32(OFFSET), kv_valid_len=jnp.int32(valid))
    ht = tdec.decoder_forward(td, tcfg, torch.from_numpy(x).to(torch.bfloat16), tc,
                              valid, prefill=False, cache_offset=OFFSET)
    live = valid - OFFSET   # block rows that are not padding
    assert ht.shape == (T, dcfg.hidden_size) and torch.isfinite(ht.float()).all()
    assert _rel(ht.float().numpy()[:live], np.asarray(hj, np.float32)[:live]) < 1e-2
    for n in ("k", "v"):
        for l in range(dcfg.n_layers):
            got, want = _rows(tc, n, OFFSET, OFFSET + live), _rows(jc2, n, OFFSET, OFFSET + live)
            assert _rel(got[l], want[l]) < 1e-2, (n, l)
        for key in (n, n + "_s"):
            if key in tc:
                assert torch.equal(tc[key][:, :OFFSET], before[key][:, :OFFSET])
                assert torch.equal(tc[key][:, OFFSET + T:], before[key][:, OFFSET + T:])


def test_block_decode_ignores_rows_from_the_offset(trees):
    """The rows at and past cache_offset (a draft's) are never read: other
    values there give the same hidden states bit for bit."""
    dcfg, by_kind = trees
    _, td = by_kind["int8pc"]
    tcfg = port_config(dcfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, dcfg.hidden_size)).astype(np.float32) * 0.1).to(torch.bfloat16)
    _, c1 = _cache(dcfg, "int8", seed=1)
    _, c2 = _cache(dcfg, "int8", seed=2)
    for n in c2:
        c2[n][:, :OFFSET] = c1[n][:, :OFFSET]
    h1 = tdec.decoder_forward(td, tcfg, x, c1, OFFSET + 4, prefill=False, cache_offset=OFFSET)
    h2 = tdec.decoder_forward(td, tcfg, x, c2, OFFSET + 4, prefill=False, cache_offset=OFFSET)
    assert torch.equal(h1, h2)


def test_block_rows_equal_single_rows(trees):
    """int8pc leaves: a block of 5 rows against 5 single-row steps. Layer
    0's fresh int8 codes and scales are equal (its inputs are, and the W8A8
    products are exact per row); after it the attention's f32 sums over
    another shape may round a bf16 value the other way, so the hidden
    states and the later layers' dequantized rows agree to relative L2 <
    1e-2."""
    dcfg, by_kind = trees
    _, td = by_kind["int8pc"]
    tcfg = port_config(dcfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, dcfg.hidden_size)).astype(np.float32) * 0.1).to(torch.bfloat16)
    _, cb = _cache(dcfg, "int8")
    _, cs = _cache(dcfg, "int8")
    hb = tdec.decoder_forward(td, tcfg, x, cb, OFFSET + 5, prefill=False, cache_offset=OFFSET)
    hs = torch.cat([tdec.decoder_forward(td, tcfg, x[t:t + 1], cs, OFFSET + t + 1,
                                         prefill=False, cache_offset=OFFSET + t)
                    for t in range(5)])
    assert _rel(hb.float().numpy(), hs.float().numpy()) < 1e-2
    for n in ("k", "v"):
        for key in (n, n + "_s"):
            assert torch.equal(cb[key][0, OFFSET:OFFSET + 5], cs[key][0, OFFSET:OFFSET + 5])
        got, want = _rows(cb, n, OFFSET, OFFSET + 5), _rows(cs, n, OFFSET, OFFSET + 5)
        assert _rel(got, want) < 1e-2, n
