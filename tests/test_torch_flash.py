"""Flash attention: the port's twin vs the JAX Pallas kernel in interpret
mode (atol 1e-5 in f32: same math, f32 sums in another order). The CUDA
kernel vs the twin: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.ops.pallas_attention import flash_attention_batch as jax_flash
from qwen3_asr_tpu_torch.ops import flash_attention as tfa


def _inputs(B, T, S, NH, NKV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, NH, D)).astype(np.float32)
    k = rng.standard_normal((B, S, NKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, NKV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,valid", [(True, [37, 64]), (False, [50, 21])])
def test_twin_matches_pallas_interpret(causal, valid):
    B, T, NH, NKV, D = 2, 64, 4, 2, 16
    q, k, v = _inputs(B, T, T, NH, NKV, D, int(causal))
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(valid, jnp.int32), causal=causal,
                                scale=scale, interpret=True))
    before = tfa.flash_attention_batch.launches
    got = tfa.flash_attention_batch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(valid, dtype=torch.int32), causal=causal, scale=scale)
    assert tfa.flash_attention_batch.launches == before  # CPU: the twin
    rows = slice(None) if not causal else slice(0, min(valid))
    np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows], atol=1e-5,
                               rtol=0)
    if causal:  # padding rows only matter to the first item's valid rows
        np.testing.assert_allclose(got.numpy()[1], want[1], atol=1e-5, rtol=0)


def test_single_item_entry():
    q, k, v = _inputs(1, 16, 16, 2, 1, 8, 3)
    t = [torch.from_numpy(a[0]) for a in (q, k, v)]
    got = tfa.flash_attention(*t, 11, causal=True, scale=0.5)
    want = tfa.flash_attention_ref(*(x[None] for x in t),
                                   torch.tensor([11], dtype=torch.int32),
                                   causal=True, scale=0.5)[0]
    assert torch.equal(got, want)


def _bf(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case,exc", [
    ("head_dim_96", ValueError), ("gqa_13_over_3", ValueError),
    ("k_shape", ValueError), ("f32_q", TypeError), ("valid_shape", ValueError),
    ("valid_f32", TypeError), ("three_dims", ValueError)])
def test_kernel_argument_checks_raise(case, exc):
    """The checks the wrapper makes before any launch (check_kernel_args),
    on CPU tensors: a head dim other than 64 / 128, NH not a multiple of NKV,
    mismatched k / v, wrong dtypes or valid lengths raise; the kernel's own
    shapes pass."""
    q, k, v = _bf(2, 40, 16, 128), _bf(2, 40, 8, 128), _bf(2, 40, 8, 128)
    valid = torch.tensor([40, 7], dtype=torch.int32)
    tfa.check_kernel_args(q, k, v, valid)
    tfa.check_kernel_args(_bf(1, 9, 14, 64), _bf(1, 9, 14, 64), _bf(1, 9, 14, 64),
                          valid[:1])
    args = {"head_dim_96": (_bf(2, 40, 16, 96), _bf(2, 40, 8, 96), _bf(2, 40, 8, 96),
                            valid),
            "gqa_13_over_3": (_bf(2, 40, 13, 64), _bf(2, 40, 3, 64), _bf(2, 40, 3, 64),
                              valid),
            "k_shape": (q, _bf(2, 40, 8, 64), v, valid),
            "f32_q": (q.float(), k, v, valid),
            "valid_shape": (q, k, v, valid[:1]),
            "valid_f32": (q, k, v, valid.float()),
            "three_dims": (q[0], k[0], v[0], valid)}[case]
    with pytest.raises(exc):
        tfa.check_kernel_args(*args)
