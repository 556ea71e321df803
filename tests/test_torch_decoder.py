"""Port prefill vs the JAX `decoder_forward(prefill=True)` on the same fused
int8pc weights at the tiny config, in bf16.

The JAX CPU program runs with XLA's excess precision: inside a fusion some
bf16 intermediates (the residual sum before the FFN norm, for one) stay in
f32, where the port rounds them as the code says. Layer 0 agrees bit for
bit; from layer 1 on the bf16 hidden states differ in the last bit, which
moves int8 K/V codes by a step or more. So the stated tolerances are held
per layer, each layer fed the JAX package's own input hidden state:
hidden states relative L2 < 1e-2, int8 K/V codes within +-1 on at most 1% of
entries, scales rtol 1e-2. The whole stack run free is held to relative
L2 < 1e-2 on the hidden states and to an equal first greedy token."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import jax_tree, port_config


@pytest.fixture(scope="module")
def setup():
    from qwen3_asr_tpu.config import tiny_asr_config

    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=11)
    return cfg, tree, from_jax_params(tree, port_config(cfg))


def _live(a, n):
    return np.asarray(a, np.float32)[:, :n]


def _layer(tree_layers, l):
    return {k: ({kk: vv[l:l + 1] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l:l + 1]) for k, v in tree_layers.items()}


def _inputs(dcfg):
    P, n_prompt, n_audio, off = 48, 40, 20, 9
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, dcfg.vocab_size - 10, P).astype(np.int32)
    audio = (rng.standard_normal((n_audio, dcfg.hidden_size)) * 0.05
             ).astype(np.float32)
    return P, n_prompt, n_audio, off, tokens, audio


def _jax_prefill(jd, dcfg, h0, P, n_prompt, S=128):
    cache = jdec.init_kv_cache(dcfg, S, jnp.int8)
    return jdec.decoder_forward(
        jd, dcfg, h0, jnp.arange(P, dtype=jnp.int32), cache,
        cache_offset=jnp.int32(0), kv_valid_len=jnp.int32(n_prompt),
        prefill=True)


def test_prefill_matches_jax(setup):
    cfg, tree, tp = setup
    dcfg = cfg.decoder
    P, n_prompt, n_audio, off, tokens, audio = _inputs(dcfg)
    jd, td = tree["decoder"], tp["decoder"]
    h0 = jdec.embed_with_audio(jd, jnp.asarray(tokens),
                               jnp.asarray(audio, jnp.bfloat16), n_audio, off)
    h0_t = tdec.embed_with_audio(td, torch.from_numpy(tokens).long(),
                                 torch.from_numpy(audio).to(torch.bfloat16),
                                 n_audio, off)
    np.testing.assert_array_equal(h0_t.float().numpy(),
                                  np.asarray(h0, np.float32))

    hj, _ = _jax_prefill(jd, dcfg, h0, P, n_prompt)
    tok_j = int(jnp.argmax(jdec.lm_logits(jd, dcfg, hj[n_prompt - 1])))
    tcfg = port_config(dcfg)
    ht = tdec.decoder_forward(td, tcfg, h0_t, tdec.init_kv_cache(tcfg, 128, "cpu"),
                              n_prompt)
    tok_t = int(torch.argmax(tdec.lm_logits(td, tcfg, ht[n_prompt - 1])))
    a = ht.float().numpy()[:n_prompt]
    b = np.asarray(hj, np.float32)[:n_prompt]
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-2
    assert tok_t == tok_j


def test_prefill_layers_match_jax(setup):
    """Each layer fed the JAX hidden state: hidden, K/V codes and scales."""
    cfg, tree, tp = setup
    dcfg1 = dataclasses.replace(cfg.decoder, n_layers=1)
    P, n_prompt, n_audio, off, tokens, audio = _inputs(cfg.decoder)
    jd, td = tree["decoder"], tp["decoder"]
    h = jdec.embed_with_audio(jd, jnp.asarray(tokens),
                              jnp.asarray(audio, jnp.bfloat16), n_audio, off)
    for l in range(cfg.decoder.n_layers):
        jl = dict(jd, layers=_layer(jd["layers"], l))
        tl = dict(td, layers=_layer(td["layers"], l))
        hj, cache_j = _jax_prefill(jl, dcfg1, h, P, n_prompt)
        cache_t = tdec.init_kv_cache(port_config(dcfg1), 128, "cpu")
        ht = tdec.decoder_forward(
            tl, port_config(dcfg1), torch.from_numpy(np.asarray(h, np.float32)).to(
                torch.bfloat16), cache_t, n_prompt)
        a = ht.float().numpy()[:n_prompt]
        b = np.asarray(hj, np.float32)[:n_prompt]
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 1e-2, (l, rel)
        for name in ("k", "v"):
            got = _live(cache_t[name].numpy(), n_prompt).astype(np.int32)
            want = _live(cache_j[name], n_prompt).astype(np.int32)
            diff = np.abs(got - want)
            assert diff.max() <= 1, (l, name)
            assert (diff > 0).mean() <= 0.01, (l, name, (diff > 0).mean())
            np.testing.assert_allclose(
                _live(cache_t[name + "_s"].numpy(), n_prompt),
                _live(cache_j[name + "_s"], n_prompt), rtol=1e-2)
        h = hj


def test_lm_logits_pc_head(setup):
    cfg, tree, tp = setup
    rng = np.random.default_rng(1)
    h = rng.standard_normal(cfg.decoder.hidden_size).astype(np.float32)
    want = np.asarray(jdec.lm_logits(tree["decoder"], cfg.decoder,
                                     jnp.asarray(h, jnp.bfloat16)))
    got = tdec.lm_logits(tp["decoder"], port_config(cfg.decoder),
                         torch.from_numpy(h).to(torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_quantize_kv_rows_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, 2, 16)).astype(np.float32)
    qj, sj = jax.jit(jdec._quantize_kv_rows)(jnp.asarray(x))
    qt, st = tdec._quantize_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_decode_branch_not_ported(setup):
    """The decode branch runs the fused dense and Q8_0 layouts through K4
    (tests/test_torch_q8_e2e.py). On int8pc leaves, where it raised before
    the block decode was ported, a step now runs (held against the JAX
    package in tests/test_torch_spec.py): it returns a finite row and writes
    cache row cache_offset alone; use_decode_attn_kernel=False, which
    raised first on these leaves, takes the same block decode (the
    reference's XLA attention) and gives the same row (it does so on the
    fused dense and Q8_0 layouts too, single and batched:
    tests/test_torch_q8_e2e.py, tests/test_torch_batch_modes.py). A
    kv_valid_len outside (cache_offset, cache_offset + T] raises."""
    cfg, _, tp = setup
    dcfg = port_config(cfg.decoder)
    cache = tdec.init_kv_cache(dcfg, 8, "cpu")
    x = torch.zeros(1, dcfg.hidden_size, dtype=torch.bfloat16)
    h = tdec.decoder_forward(tp["decoder"], dcfg, x, cache, 2, prefill=False,
                             cache_offset=1)
    assert h.shape == (1, dcfg.hidden_size) and torch.isfinite(h.float()).all()
    written = cache["k_s"].abs().sum(dim=(0, 2)) > 0
    assert written.tolist() == [False, True] + [False] * 6
    no_dak = tdec.decoder_forward(tp["decoder"], dataclasses.replace(
        dcfg, use_decode_attn_kernel=False), x, cache, 2, prefill=False,
        cache_offset=1)
    assert torch.equal(no_dak, h)
    with pytest.raises(ValueError):
        tdec.decoder_forward(tp["decoder"], dcfg, x, cache, 5, prefill=False,
                             cache_offset=1)
