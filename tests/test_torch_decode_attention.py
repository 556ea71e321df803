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
