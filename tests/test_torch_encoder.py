"""Port encoder vs the JAX `_encode_jit`, f32 weights at the tiny config
(rtol 1e-4, atol 1e-4: the same f32 ops, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.models.encoder import _encode_jit
from qwen3_asr_tpu.models.encoder import sinusoidal_pe as jax_pe
from qwen3_asr_tpu.runtime.params import init_encoder_params
from qwen3_asr_tpu_torch.models import encoder as tenc
from qwen3_asr_tpu_torch.runtime.params import to_torch
from test_torch_params import port_config


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config().encoder
    p = jax.tree.map(np.asarray,
                     init_encoder_params(cfg, jax.random.PRNGKey(5), jnp.float32))
    # non-trivial norms and biases so every term of the block is exercised
    rng = np.random.default_rng(5)
    for k in ("attn_norm_w", "ffn_norm_w"):
        p["layers"][k] = (1 + 0.1 * rng.standard_normal(p["layers"][k].shape)
                          ).astype(np.float32)
    for k in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        p["layers"][k] = (0.02 * rng.standard_normal(p["layers"][k].shape)
                          ).astype(np.float32)
    tp = jax.tree.map(lambda a: to_torch(a), p)
    return cfg, p, tp


@pytest.mark.parametrize("n_frames", [250, 100])
def test_encoder_matches_jax(setup, n_frames):
    cfg, p, tp = setup
    rng = np.random.default_rng(n_frames)
    mel = rng.standard_normal((cfg.n_mel_bins, n_frames)).astype(np.float32)
    want = np.asarray(_encode_jit(p, cfg, jnp.asarray(mel), n_frames))
    got = tenc.encode(tp, port_config(cfg), torch.from_numpy(mel), n_frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_chunk_helpers():
    from qwen3_asr_tpu.models.encoder import chunk_output_len

    for n in (1, 7, 50, 99, 100):
        assert tenc.chunk_output_len(n) == chunk_output_len(n)
    np.testing.assert_allclose(tenc.sinusoidal_pe(13, 32),
                               np.asarray(jax_pe(13, 32)), atol=1e-7)
