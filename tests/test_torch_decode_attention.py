"""Single-token decode attention: the port's K4 twin vs the JAX Pallas
kernel (`decode_attention(..., interpret=True)`), with a bf16 and an int8
cache, at offset 0 (only the fresh column), mid-cache and S - 1. The CUDA
kernel vs the twin: tests/test_torch_cuda.py.

Tolerance: rtol 1e-4, atol 1e-5 x the output's scale. Both compute the same
f32 math (norms, RoPE, scores, one softmax with the fresh column); the sums
run in another order and exp / cos / sin are other implementations, which
moves the last f32 bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.models.decoder import _quantize_kv_rows as jax_quant_rows
from qwen3_asr_tpu.ops.decode_attention import decode_attention as jax_da
from qwen3_asr_tpu_torch.ops import decode_attention as tda

NH, NKV, D, S = 4, 2, 128, 96
EPS, THETA = 1e-6, 1e6


def _inputs(seed, quant):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((1, (NH + 2 * NKV) * D)).astype(np.float32)
    k = (rng.standard_normal((S, NKV, D)) * 0.8).astype(np.float32)
    v = rng.standard_normal((S, NKV, D)).astype(np.float32)
    qn = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    kn = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    j = dict(qkv=jnp.asarray(qkv, jnp.bfloat16), qn=jnp.asarray(qn, jnp.bfloat16),
             kn=jnp.asarray(kn, jnp.bfloat16), scales={})
    if quant:
        kq, ks = jax_quant_rows(jnp.asarray(k))
        vq, vs = jax_quant_rows(jnp.asarray(v))
        j.update(k=kq, v=vq, scales=dict(k_scale=ks, v_scale=vs))
    else:
        j.update(k=jnp.asarray(k, jnp.bfloat16), v=jnp.asarray(v, jnp.bfloat16))

    def t(a):   # bf16 values travel as f32 (exact)
        return torch.from_numpy(np.array(a, np.float32 if a.dtype == jnp.bfloat16
                                         else a.dtype))

    tt = {name: t(j[name]) for name in ("qkv", "qn", "kn", "k", "v")}
    for name in ("qkv", "qn", "kn"):
        tt[name] = tt[name].to(torch.bfloat16)
    if not quant:
        tt["k"], tt["v"] = tt["k"].to(torch.bfloat16), tt["v"].to(torch.bfloat16)
    tt["scales"] = {n: t(a) for n, a in j["scales"].items()}
    return j, tt


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("offset,pos", [(0, 0), (37, 37), (S - 1, S - 1), (37, 40)])
def test_decode_attention_twin_matches_pallas(quant, offset, pos):
    j, t = _inputs(offset + 7 * quant, quant)
    kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=EPS, theta=THETA,
              scale=1.0 / np.sqrt(D))
    want = jax_da(j["qkv"], j["k"], j["v"], j["qn"], j["kn"], offset, pos,
                  interpret=True, **kw, **j["scales"])
    got = tda.decode_attention(t["qkv"], t["k"], t["v"], t["qn"], t["kn"], offset,
                               pos, **kw, **t["scales"])
    for g, w, name in zip(got, want, ("attn", "k_new", "v_new")):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)


def test_offset_zero_is_the_fresh_row():
    """With no cache rows, every q head's output is its KV head's fresh v."""
    _, t = _inputs(3, False)
    attn, _, v_new = tda.decode_attention(
        t["qkv"], t["k"], t["v"], t["qn"], t["kn"], 0, 5, n_heads=NH, n_kv=NKV,
        head_dim=D, eps=EPS, theta=THETA, scale=0.1)
    want = v_new[0].repeat_interleave(NH // NKV, dim=0).reshape(1, -1)
    torch.testing.assert_close(attn, want, rtol=1e-6, atol=1e-6)


STORE_OFFSETS = (0, 1, 63, 64, 65, S - 1)


def _filled(seed, quant, lead=()):
    """Caches [*lead, S, NKV, D] with every row drawn (int8 with scales)."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((*lead, S, NKV, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((*lead, S, NKV, D)).astype(np.float32))
    if quant:
        (k, ks), (v, vs) = tda._quantize_kv_rows(k), tda._quantize_kv_rows(v)
        return {"k": k, "v": v, "k_s": ks, "v_s": vs}
    return {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


def _args(c):
    return c["k"], c["v"], dict(k_scale=c.get("k_s"), v_scale=c.get("v_s"))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("batched", [False, True], ids=["one_row", "batched"])
@pytest.mark.parametrize("offset", STORE_OFFSETS)
def test_twin_store_is_the_decoders_store(quant, batched, offset):
    """The twin with store=True returns what it returns without, and leaves
    both caches torch.equal to `models/decoder.py::_store` of its own k_new /
    v_new at row offset (bf16 rounded to nearest even, or int8 codes and
    scales), every other row untouched. Batched: three slabs, the middle
    one at `offset`, the others at other chunk positions, each row stored
    in its own slab (the decoder's pool [B, L, S, n_kv * D] for _store)."""
    from qwen3_asr_tpu_torch.models.decoder import _store

    _, t = _inputs(offset + 3 * quant, quant)
    kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=EPS, theta=THETA,
              scale=1.0 / np.sqrt(D))
    if batched:
        offs = [(offset + 40) % S, offset, S - 1 - offset % 7]
        B = len(offs)
        rng = np.random.default_rng(offset)
        qkv = torch.from_numpy(rng.standard_normal((B, (NH + 2 * NKV) * D))
                               .astype(np.float32)).to(torch.bfloat16)
        base = _filled(offset + 1, quant, (B,))
        got_c = {n: x.clone() for n, x in base.items()}
        od = torch.tensor(offs, dtype=torch.int32)
        args = (qkv, t["qn"], t["kn"], od, od + 2)
        k, v, sc = _args(got_c)
        got = tda.decode_attention_batch(args[0], k, v, *args[1:], max(offs), **kw, **sc,
                                         store=True)
        k, v, sc = _args(base)
        plain = tda.decode_attention_batch(args[0], k, v, *args[1:], max(offs), **kw, **sc)
        # _store on the decoder's pool layout [B, L = 1, S, n_kv * D]
        want_c = {n: (x.flatten(-2) if n in ("k", "v") else x)[:, None].clone()
                  for n, x in base.items()}
        _store(want_c, 0, (torch.arange(B), od.long()), plain[1], plain[2])
        want_c = {n: (x[:, 0].unflatten(-1, (NKV, D)) if n in ("k", "v") else x[:, 0])
                  for n, x in want_c.items()}
        rows = [(b, o) for b, o in enumerate(offs)]
    else:
        base = _filled(offset + 1, quant)
        got_c = {n: x.clone() for n, x in base.items()}
        k, v, sc = _args(got_c)
        got = tda.decode_attention(t["qkv"], k, v, t["qn"], t["kn"], offset, offset + 2,
                                   **kw, **sc, store=True)
        k, v, sc = _args(base)
        plain = tda.decode_attention(t["qkv"], k, v, t["qn"], t["kn"], offset, offset + 2,
                                     **kw, **sc)
        want_c = {n: x[None].clone() for n, x in base.items()}
        _store(want_c, 0, offset, plain[1][0], plain[2][0])
        want_c = {n: x[0] for n, x in want_c.items()}
        rows = [(None, offset)]
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    for n in base:
        assert torch.equal(got_c[n], want_c[n]), n
        for b, o in rows:
            sl = (lambda x: x[b]) if b is not None else (lambda x: x)
            assert torch.equal(sl(got_c[n])[:o], sl(base[n])[:o]), (n, b)
            assert torch.equal(sl(got_c[n])[o + 1:], sl(base[n])[o + 1:]), (n, b)
            assert not torch.equal(sl(got_c[n])[o], sl(base[n])[o]), (n, b)


def test_store_rejects_a_row_at_S():
    """store=True writes cache row offset: an offset of S (no such row)
    raises, one-row and batched."""
    _, t = _inputs(5, False)
    c = _filled(6, False)
    kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=EPS, theta=THETA, scale=0.1)
    tda.decode_attention(t["qkv"], c["k"], c["v"], t["qn"], t["kn"], S, S, **kw)
    with pytest.raises(ValueError, match="store=True"):
        tda.decode_attention(t["qkv"], c["k"], c["v"], t["qn"], t["kn"], S, S, **kw,
                             store=True)
    cb = _filled(7, False, (2,))
    offs = torch.tensor([3, S], dtype=torch.int32)
    qkv = t["qkv"].expand(2, -1).contiguous()
    with pytest.raises(ValueError, match="store=True"):
        tda.decode_attention_batch(qkv, cb["k"], cb["v"], t["qn"], t["kn"], offs, offs, S,
                                   **kw, store=True)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_store_rejects_a_bound_of_S(quant):
    """The batched kernel does not read its offsets back on the host, so
    with store=True its bound, at least every offset, must be < S: a bound
    of S raises even when every offset is below S (and leaves the caches as
    they were); with the store off the same call runs."""
    _, t = _inputs(8, quant)
    c = _filled(9, quant, (2,))
    before = {n: x.clone() for n, x in c.items()}
    kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=EPS, theta=THETA, scale=0.1)
    offs = torch.tensor([3, S - 1], dtype=torch.int32)
    qkv = t["qkv"].expand(2, -1).contiguous()
    k, v, sc = _args(c)
    with pytest.raises(ValueError, match="store=True"):
        tda.decode_attention_batch(qkv, k, v, t["qn"], t["kn"], offs, offs, S, **kw, **sc,
                                   store=True)
    for n in c:
        assert torch.equal(c[n], before[n]), n
    tda.decode_attention_batch(qkv, k, v, t["qn"], t["kn"], offs, offs, S, **kw, **sc)
    tda.decode_attention_batch(qkv, k, v, t["qn"], t["kn"], offs, offs, S - 1, **kw, **sc,
                               store=True)
