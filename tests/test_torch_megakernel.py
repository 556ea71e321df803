"""Int4-weight / int8-KV decode step: the port's twin vs the JAX Pallas
megakernel (`mega_decode_step_i8` on an int4 pack, interpret mode). The
CUDA kernels vs the twin: tests/test_torch_cuda.py.

Both packages get the same fused int8pc weights and the same int8 cache.
Over 4 free-running steps: tokens equal; h (the pre-norm hidden state)
relative L2 < 2e-2, as tests/test_megakernel.py gates the kernel; every
fresh cache row within one code step, scales rtol 1e-2. The interpret-mode
kernel runs as an XLA CPU program with excess precision (some bf16
intermediates of the residual path stay f32), so from layer 1 on the codes
move by one step more often than 1%; the +-1-on-at-most-1% rule is held per
layer, each layer's step fed the JAX kernel's own input row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.decoder import _quantize_kv_rows
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import jax_tree, port_config

S, POS0, STEPS = 32, 12, 4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=3)
    mega = jmk.pack_megakernel_params(tree["decoder"], cfg.decoder, int4=True)
    return cfg.decoder, tree, mega, from_jax_params(tree, port_config(cfg))["decoder"]


def _cache(dcfg, seed):
    """int8 rows + scales for rows < POS0 (rows past it are zero)."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((L, POS0, NKV, D)).astype(np.float32) * 0.5
    q, s = jax.jit(_quantize_kv_rows)(jnp.asarray(rows))
    k = np.zeros((L, S, NKV * D), np.int8)
    ks = np.zeros((L, S, NKV), np.float32)
    k[:, :POS0] = np.asarray(q).reshape(L, POS0, NKV * D)
    ks[:, :POS0] = np.asarray(s)
    return k, ks


def test_twin_matches_jax_kernel(setup):
    dcfg, tree, mega, td = setup
    k0, ks0 = _cache(dcfg, 1)
    v0, vs0 = _cache(dcfg, 2)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    jks, jvs = jnp.asarray(ks0.transpose(0, 2, 1)), jnp.asarray(vs0.transpose(0, 2, 1))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tks, tvs = torch.from_numpy(ks0.copy()), torch.from_numpy(vs0.copy())
    embd = tree["decoder"]["token_embd"]
    tok = 7
    for i in range(STEPS):
        pos = POS0 + i
        x = jnp.asarray(embd[tok][None])
        jtok, jk, jv, jks, jvs, jh = jmk.mega_decode_step_i8(
            mega, dcfg, x, jnp.int32(pos), jk, jv, jks, jvs, interpret=True)
        ttok, th = tmk.mega_decode_step_i8(
            td["mega"], port_config(dcfg), torch.tensor([tok], dtype=torch.int32), pos,
            tk, tv, tks, tvs)
        assert int(ttok[0]) == int(jtok), f"step {i}"
        a, b = th.numpy(), np.asarray(jh)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2, i
        for name, got, want, gs, ws in (
                ("k", tk, jk, tks, jks), ("v", tv, jv, tvs, jvs)):
            d = np.abs(got[:, pos].numpy().astype(int)
                       - np.asarray(want)[:, pos].astype(int))
            assert d.max() <= 1, (name, i)
            assert (d[0] > 0).mean() <= 0.01, (name, i)  # layer 0
            np.testing.assert_allclose(gs[:, pos].numpy(),
                                       np.asarray(ws)[:, :, pos], rtol=1e-2)
        # rows before pos are untouched by the step
        np.testing.assert_array_equal(tk[:, :POS0].numpy(), k0[:, :POS0])
        tok = int(jtok)


_JAX_LAYER_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q",
                   "wd_s", "norms", "lsc")
_PORT_LAYER_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q",
                    "wd_s", "attn_norm", "ffn_norm", "q_norm", "k_norm")


def test_twin_layers_match_jax_kernel(setup):
    """One step at POS0, layer by layer through one-layer packs, each fed
    the JAX kernel's hidden state: codes within +-1 on at most 1%."""
    import dataclasses

    dcfg, tree, mega, td = setup
    dcfg1 = dataclasses.replace(dcfg, n_layers=1)
    k0, ks0 = _cache(dcfg, 1)
    v0, vs0 = _cache(dcfg, 2)
    x = np.asarray(tree["decoder"]["token_embd"][7][None])
    for l in range(dcfg.n_layers):
        jm = {k: (v[l:l + 1] if k in _JAX_LAYER_KEYS else v) for k, v in mega.items()}
        tm = {k: (v[l:l + 1] if k in _PORT_LAYER_KEYS else v)
              for k, v in td["mega"].items()}
        sl = slice(l, l + 1)
        _, jk, jv, jks, jvs, jh = jmk.mega_decode_step_i8(
            jm, dcfg1, jnp.asarray(x), jnp.int32(POS0), jnp.asarray(k0[sl]),
            jnp.asarray(v0[sl]), jnp.asarray(ks0[sl].transpose(0, 2, 1)),
            jnp.asarray(vs0[sl].transpose(0, 2, 1)), interpret=True)
        tk, tv = torch.from_numpy(k0[sl].copy()), torch.from_numpy(v0[sl].copy())
        tks, tvs = torch.from_numpy(ks0[sl].copy()), torch.from_numpy(vs0[sl].copy())
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        _, th = tmk.mega_decode_step_i8(tm, port_config(dcfg1), xt, POS0, tk, tv, tks, tvs)
        a, b = th.numpy(), np.asarray(jh)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-2, l
        for name, got, want, gs, ws in (
                ("k", tk, jk, tks, jks), ("v", tv, jv, tvs, jvs)):
            d = np.abs(got[0, POS0].numpy().astype(int)
                       - np.asarray(want)[0, POS0].astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 0.01, (name, l)
            np.testing.assert_allclose(gs[0, POS0].numpy(),
                                       np.asarray(ws)[0, :, POS0], rtol=1e-2)
        x = np.asarray(jh).astype(jnp.bfloat16)


def test_twin_token_input_equals_row_input(setup):
    dcfg, tree, _, td = setup
    caches = [torch.from_numpy(a) for a in (*_cache(dcfg, 1), *_cache(dcfg, 2))]
    k, ks, v, vs = caches
    a = tmk.mega_decode_step_i8(td["mega"], port_config(dcfg), torch.tensor([5], dtype=torch.int32),
                                POS0, k.clone(), v.clone(), ks.clone(), vs.clone())
    x = td["token_embd"][5][None]
    b = tmk.mega_decode_step_i8(td["mega"], port_config(dcfg), x, POS0, k.clone(), v.clone(),
                                ks.clone(), vs.clone())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
