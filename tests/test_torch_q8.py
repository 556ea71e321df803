"""Q8_0 weights: the port's K5 / K6 / K7 twins vs the JAX Pallas kernels
(`q8_matmul`, `q8_norm_matmul`, `q8_mlp` with interpret=True), the quantizer
vs the JAX numpy quantizer, and `matmul_any`'s dispatch. The CUDA kernels vs
the twins: tests/test_torch_cuda.py.

Tolerances, each with its reason:
- quantizer codes and scales: bit-equal (the same f32 division, reciprocal,
  product and round-half-to-even);
- f32-dequant products (outputs < 2,048 columns): rtol 1e-5, atol 1e-6 x
  the output's scale (the same f32 products, summed in another order);
- bf16-dequant products (K6 / K5 from 2,048 columns, K7): the same, except
  that the norm's f32 sum order can move a normed activation across a bf16
  rounding boundary, which changes its products by a bf16 ulp: relative L2
  < 1e-4, elementwise atol 1e-3 x the output's scale (measured: ~2e-7);
- the reference at T = 1 runs on 8 copies of the row and row 0 is taken:
  for a single row XLA's CPU dot on bf16 operands does not keep f32 sums
  (measured: ~2e-3 relative off a float64 sum of the same bf16 values,
  against ~7e-8 for the twin), while the TPU's MXU and the port do; every
  row of these kernels is computed alone, so row 0 is the T = 1 result;
- above 256 rows the port runs the reference's XLA path (dequantize, one f32
  dot): rtol 1e-5, atol 1e-6 x scale, as the f32 case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.ops import q8_matmul as jq8
from qwen3_asr_tpu_torch.ops import q8_matmul as tq8

EPS = 1e-6


def _leaf(n_in, n_out, seed, pad_out_to=1):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    jl = jq8.quant_leaf(w, pad_out_to=pad_out_to)
    tl = tq8.quant_leaf(torch.from_numpy(w), pad_out_to=pad_out_to)
    return {k: np.asarray(v) for k, v in jl.items()}, tl


def _x(T, n_in, seed):
    rng = np.random.default_rng(100 + seed)
    return rng.standard_normal((T, n_in)).astype(np.float32)


def _bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _close(got, want, exact_f32: bool):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    if exact_f32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)


def _rows8(x):
    """The reference's input: x itself, or 8 copies of a single row."""
    return np.repeat(x, 8, axis=0) if x.shape[0] == 1 else x


@pytest.mark.parametrize("shape", [(64, 128), (96, 4096), (1024, 64), (3072, 64)])
def test_quantize_q8_bit_equal(shape):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero column: scale 0, codes 0
    w[rng.integers(0, shape[0], 4), rng.integers(0, shape[1], 4)] *= 9.0
    q_j, s_j = jq8.quantize_q8_weights(w)
    q_t, s_t = tq8.quantize_q8_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(q_t.numpy(), q_j)
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    back = tq8.dequantize_q8_weights(q_t, s_t).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq8.dequantize_q8_weights(
        jnp.asarray(q_j), jnp.asarray(s_j))))


def test_quant_leaf_pads_the_head():
    jl, tl = _leaf(64, 500, 1, pad_out_to=4096)
    assert tl["q8:q"].shape == (64, 4096) and tl["q8:s"].shape == (2, 4096)
    for k in ("q8:q", "q8:s"):
        np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    assert not tl["q8:q"][:, 500:].any() and not tl["q8:s"][:, 500:].any()


@pytest.mark.parametrize("n_out", [1024, 1600, 2048, 4096])
def test_deq_dtype_follows_tile_for(n_out):
    tile, dt = jq8._tile_for(n_out)
    if n_out % tile:           # the reference re-dispatches at the padded width
        tile, dt = jq8._tile_for(-(-n_out // tile) * tile)
    assert tq8.deq_bf16_for(n_out) == (dt == jnp.bfloat16)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("n_in,n_out", [(64, 128), (128, 2048)])
def test_q8_matmul_twin_matches_pallas(T, n_in, n_out):
    jl, tl = _leaf(n_in, n_out, T)
    x = _x(T, n_in, 1)
    want = jq8.q8_matmul(_bf16(_rows8(x)), jnp.asarray(jl["q8:q"]), jnp.asarray(jl["q8:s"]),
                         interpret=True)[:T]
    got = tq8.q8_matmul(torch.from_numpy(x).to(torch.bfloat16), tl["q8:q"], tl["q8:s"])
    assert got.dtype == torch.float32
    _close(got.numpy(), want, exact_f32=n_out < 2048)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("n_in,n_out,pad", [(64, 128, 1), (64, 4096, 1), (64, 500, 4096)])
def test_q8_norm_matmul_twin_matches_pallas(T, n_in, n_out, pad):
    """(64, 500) padded to 4,096 columns is the tiny lm head's shape."""
    jl, tl = _leaf(n_in, n_out, 10 + T, pad_out_to=pad)
    x = _x(T, n_in, 2)
    nw = (1 + 0.1 * np.random.default_rng(3).standard_normal(n_in)).astype(np.float32)
    want = jq8.q8_norm_matmul(_bf16(_rows8(x)), {k: jnp.asarray(v) for k, v in jl.items()},
                              _bf16(nw), EPS, interpret=True)[:T]
    got = tq8.q8_norm_matmul(torch.from_numpy(x).to(torch.bfloat16), tl,
                             torch.from_numpy(nw).to(torch.bfloat16), EPS)
    assert got.shape == (T, tl["q8:q"].shape[1])
    _close(got.numpy(), want, exact_f32=not tq8.deq_bf16_for(tl["q8:q"].shape[1]))


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("n_ffn", [96, 2048])
def test_q8_mlp_twin_matches_pallas(T, n_ffn):
    """n_ffn 96: the Pallas grid's one gate/up tile; 2,048: two tiles."""
    n_in = 64
    jgu, tgu = _leaf(n_in, 2 * n_ffn, 20 + T)
    jd, td = _leaf(n_ffn, n_in, 30 + T)
    x = _x(T, n_in, 4)
    nw = (1 + 0.1 * np.random.default_rng(5).standard_normal(n_in)).astype(np.float32)
    want = jq8.q8_mlp(_bf16(_rows8(x)), {k: jnp.asarray(v) for k, v in jgu.items()},
                      {k: jnp.asarray(v) for k, v in jd.items()}, _bf16(nw), EPS,
                      n_ffn, interpret=True)[:T]
    got = tq8.q8_mlp(torch.from_numpy(x).to(torch.bfloat16), tgu, td,
                     torch.from_numpy(nw).to(torch.bfloat16), EPS, n_ffn)
    _close(got.numpy(), want, exact_f32=False)


def test_above_256_rows_is_the_reference_xla_path():
    """T = 300: the port's f32 dequantize-and-dot equals the JAX package's
    XLA path (which its CPU backend takes at any T)."""
    jgu, tgu = _leaf(64, 192, 40)
    jd, td = _leaf(96, 64, 41)
    x = _x(300, 64, 6)
    xb, xt = _bf16(x), torch.from_numpy(x).to(torch.bfloat16)
    nw = np.ones(64, np.float32)
    jleaf = {k: jnp.asarray(v) for k, v in jgu.items()}
    pairs = [
        (jq8.q8_matmul(xb, jleaf["q8:q"], jleaf["q8:s"]),
         tq8.q8_matmul(xt, tgu["q8:q"], tgu["q8:s"])),
        (jq8.q8_norm_matmul(xb, jleaf, _bf16(nw), EPS),
         tq8.q8_norm_matmul(xt, tgu, torch.from_numpy(nw).to(torch.bfloat16), EPS)),
        (jq8.q8_mlp(xb, jleaf, {k: jnp.asarray(v) for k, v in jd.items()}, _bf16(nw),
                    EPS, 96),
         tq8.q8_mlp(xt, tgu, td, torch.from_numpy(nw).to(torch.bfloat16), EPS, 96)),
    ]
    before = (tq8.q8_matmul.launches, tq8.q8_norm_matmul.launches, tq8.q8_mlp.launches)
    for want, got in pairs:
        _close(got.numpy(), want, exact_f32=True)
    assert (tq8.q8_matmul.launches, tq8.q8_norm_matmul.launches,
            tq8.q8_mlp.launches) == before


def test_matmul_any_dispatch():
    jl, tl = _leaf(64, 128, 50)
    x = torch.from_numpy(_x(3, 64, 7)).to(torch.bfloat16)
    got = tq8.matmul_any(x, tl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), tq8.q8_matmul(x, tl["q8:q"], tl["q8:s"]).to(
            torch.bfloat16).float().numpy())
    w = torch.from_numpy(_x(64, 128, 8)).to(torch.bfloat16)
    np.testing.assert_array_equal(tq8.matmul_any(x, w).float().numpy(),
                                  (x @ w).float().numpy())
    q, s = tq8.quantize_pc_weights(w)
    pc = {"i8pc:q": q, "i8pc:s": s}
    np.testing.assert_array_equal(tq8.matmul_any(x, pc).float().numpy(),
                                  tq8.pc_matmul(x, q, s).to(torch.bfloat16).float().numpy())
    want = jq8.matmul_any(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          {k: jnp.asarray(v) for k, v in jl.items()})
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    assert tq8.is_quant_leaf(tl) and not tq8.is_quant_leaf(pc) and tq8.is_pc_leaf(pc)
