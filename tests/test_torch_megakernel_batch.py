"""Batched decode step over the int8 KV cache: the port's plain version vs
the JAX Pallas kernel (`mega_decode_step_batch`, interpret mode) on the
int4 and the int8 pack, and vs the port's single-sequence plain step row by
row. The
CUDA kernels vs the plain version: tests/test_torch_cuda.py.

B = 3 sequences at different positions over 4 free-running steps, with
tests/test_torch_megakernel.py's bounds: tokens equal; h relative L2 <
2e-2 per row; layer 0's fresh cache rows within one code step on at most
1% of entries; scales rtol 1e-2. From layer 1 on, the interpret-mode
kernel's inputs carry XLA's excess precision (test_torch_megakernel.py),
and a code moves by two at pos 3 (the single-sequence JAX kernel reads the
same there): those layers' codes are held within two. The JAX batched
kernel equals its single-sequence kernel row by row at these positions;
the port's batched rows equal its single-sequence step exactly
(test_plain_rows_equal_single_step). The JAX kernel keeps scales as
[B, L, n_kv, S]; they are transposed here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.decoder import _quantize_kv_rows
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu.ops.megakernel_batch import mega_decode_step_batch as jax_step
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import jax_tree, port_config

S, POS0, STEPS = 32, (12, 3, 20), 4
PACKS = {"int4": True, "int8": False}


@pytest.fixture(scope="module", params=list(PACKS))
def setup(request):
    """(decoder config, JAX tree, JAX pack, the port's decoder) with the
    int4 or the int8 pack."""
    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=3)
    int4 = PACKS[request.param]
    mega = jmk.pack_megakernel_params(tree["decoder"], cfg.decoder, int4=int4)
    return (cfg.decoder, tree, mega,
            from_jax_params(tree, port_config(cfg), int4=int4)["decoder"])


def _pool(dcfg, seed):
    """[B, L, S, DKV] int8 and [B, L, S, NKV] f32: rows < POS0[b] filled."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    rng = np.random.default_rng(seed)
    B = len(POS0)
    q = np.zeros((B, L, S, NKV * D), np.int8)
    s = np.zeros((B, L, S, NKV), np.float32)
    for b, p in enumerate(POS0):
        rows = rng.standard_normal((L, p, NKV, D)).astype(np.float32) * 0.5
        qb, sb = _quantize_kv_rows(jnp.asarray(rows))
        q[b, :, :p] = np.asarray(qb).reshape(L, p, NKV * D)
        s[b, :, :p] = np.asarray(sb)
    return q, s


def test_plain_matches_jax_kernel(setup):
    dcfg, tree, mega, td = setup
    k0, ks0 = _pool(dcfg, 1)
    v0, vs0 = _pool(dcfg, 2)
    jk, jv = jnp.asarray(k0), jnp.asarray(v0)
    jks = jnp.asarray(ks0.transpose(0, 1, 3, 2))
    jvs = jnp.asarray(vs0.transpose(0, 1, 3, 2))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tks, tvs = torch.from_numpy(ks0.copy()), torch.from_numpy(vs0.copy())
    embd = tree["decoder"]["token_embd"]
    toks = np.array([7, 100, 300])
    for i in range(STEPS):
        pos = np.array(POS0) + i
        jt, jk, jv, jks, jvs, jh = jax_step(
            mega, dcfg, jnp.asarray(embd[toks]), jnp.asarray(pos, jnp.int32),
            jk, jv, jks, jvs, interpret=True)
        tt, th = tmb.mega_decode_step_batch(
            td["mega"], port_config(dcfg), torch.from_numpy(toks.astype(np.int32)), pos,
            tk, tv, tks, tvs)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=str(i))
        for b in range(len(pos)):
            a, w = th[b].numpy(), np.asarray(jh)[b]
            assert np.linalg.norm(a - w) / np.linalg.norm(w) < 2e-2, (i, b)
            for got, want, gs, ws in ((tk, jk, tks, jks), (tv, jv, tvs, jvs)):
                d = np.abs(got[b, :, pos[b]].numpy().astype(int)
                           - np.asarray(want)[b, :, pos[b]].astype(int))
                assert d[0].max() <= 1 and (d[0] > 0).mean() <= 0.01, (i, b)
                assert d.max() <= 2, (i, b)
                np.testing.assert_allclose(gs[b, :, pos[b]].numpy(),
                                           np.asarray(ws)[b, :, :, pos[b]], rtol=1e-2)
        toks = np.asarray(jt)


def test_plain_rows_equal_single_step(setup):
    """Each row of the batched plain step is the single-sequence plain step
    on that row's slab, exactly (token, h, the written cache rows)."""
    dcfg, _, _, td = setup
    pool = [torch.from_numpy(a) for a in (*_pool(dcfg, 1), *_pool(dcfg, 2))]
    k, ks, v, vs = pool
    batch = [t.clone() for t in (k, v, ks, vs)]
    toks = torch.tensor([5, 6, 7], dtype=torch.int32)
    tt, th = tmb.mega_decode_step_batch(td["mega"], port_config(dcfg), toks, POS0, *batch)
    for b, p in enumerate(POS0):
        single = [t[b].clone() for t in (k, v, ks, vs)]
        st, sh = tmk.mega_decode_step_ref(td["mega"], port_config(dcfg), toks[b:b + 1], p,
                                             *single)
        assert torch.equal(tt[b:b + 1], st) and torch.equal(th[b:b + 1], sh)
        for got, want in zip(batch, single):
            assert torch.equal(got[b], want)


@pytest.mark.parametrize("pos,err", [((0, 3, 20), "outside"), ((12, 3, 32), "outside"),
                                     ((12, 3), "positions for")])
def test_rejects_bad_positions(setup, pos, err):
    dcfg, _, _, td = setup
    pool = [torch.from_numpy(a) for a in (*_pool(dcfg, 1), *_pool(dcfg, 2))]
    k, ks, v, vs = pool
    with pytest.raises(ValueError, match=err):
        tmb.mega_decode_step_batch(td["mega"], port_config(dcfg), torch.tensor([1, 2, 3], dtype=torch.int32),
                                   pos, k, v, ks, vs)


def test_batch_step_refuses_17_rows(setup):
    """BatchDecodeStep takes at most MAX_BATCH = 16 slabs (two 8-row MMA
    n-tiles); 17 are refused before anything touches a device."""
    dcfg, _, _, td = setup
    k, ks = (torch.from_numpy(a) for a in _pool(dcfg, 1))
    big = [t[:1].expand(tmb.MAX_BATCH + 1, *t.shape[1:]).contiguous() for t in (k, k, ks, ks)]
    with pytest.raises(ValueError, match="batch 17 outside"):
        tmb.BatchDecodeStep(td["mega"], port_config(dcfg), *big)


@pytest.mark.parametrize("bounds", [(0, 12), (5, S), (12, 5), (-3, 4)])
def test_batch_step_refuses_bad_position_bounds(bounds):
    """A step's host bounds (lo, hi) of the positions must satisfy 1 <= lo
    <= hi < S; hi sizes the attention grid."""
    with pytest.raises(ValueError, match="not inside"):
        tmb.check_bounds(bounds, S)
    assert tmb.check_bounds((1, S - 1), S) == (1, S - 1)


@pytest.mark.parametrize("B,K,N", [(1, 64, 128), (13, 96, 192), (16, 1024, 64)])
def test_batch_product_plain_is_exact(B, K, N):
    """The product alone's plain version (`batch_product_i8` on CPU
    tensors): the exact int32 sums of int8 codes x int8 weights, as an
    int64 numpy product gives them; malformed operands are refused."""
    rng = np.random.default_rng(B + K + N)
    xq = rng.integers(-127, 128, (B, K), dtype=np.int8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    got = tmb.batch_product_i8(torch.from_numpy(xq), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ w.astype(np.int64))
    with pytest.raises(ValueError):
        tmb.batch_product_i8(torch.from_numpy(xq), torch.from_numpy(w[1:]))
    with pytest.raises(ValueError):
        tmb.batch_product_i8(torch.zeros(17, K, dtype=torch.int8), torch.from_numpy(w))
