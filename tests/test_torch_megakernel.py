"""The decode step on the decode pack: the port's twin
(`mega_decode_step_ref`) vs the JAX Pallas megakernel in interpret mode, in
all four resident modes: {int4, int8 weights} x {int8, bf16 KV cache}
(`mega_decode_step_i8` / `mega_decode_step` on an `int4=True` / `False`
pack). The CUDA kernels vs the twin: tests/test_torch_cuda.py.

Both packages get the same fused int8pc weights and the same cache. Over 4
free-running steps: tokens equal; h (the pre-norm hidden state) relative L2
< 2e-2, as tests/test_megakernel.py gates the kernel; every fresh cache row
within one code step and its scale at rtol 1e-2 (int8 cache), or, for
bf16 rows, within 2/127 of the head row's largest magnitude, the most the
int8 rule admits (rtol 1e-2 on layer 0, whose input is the same embedding
row in both; the free run's later layers see excess-precision inputs, up
to 1.03% of the row's magnitude apart).
The interpret-mode kernel runs as an XLA CPU program with excess precision
(some bf16 intermediates of the residual path stay f32), so from layer 1 on
the codes move by one step more often than 1%; the +-1-on-at-most-1% rule is
held per layer, each layer's step fed the JAX kernel's own input row.
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
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_params import jax_tree, port_config

S, POS0, STEPS = 32, 12, 4
PACKS = {"int4": True, "int8": False}
MODES = [(w, kv) for w in PACKS for kv in ("int8", "bf16")]


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=3)
    tcfg = port_config(cfg)
    megas = {w: jmk.pack_megakernel_params(tree["decoder"], cfg.decoder, int4=i4)
             for w, i4 in PACKS.items()}
    packs = {w: from_jax_params(tree, tcfg, int4=i4)["decoder"]["mega"]
             for w, i4 in PACKS.items()}
    return cfg.decoder, tree, megas, packs


def _cache(dcfg, seed, kv):
    """rows < POS0 filled (rows past it zero): int8 codes + scales [L, S,
    NKV], or bf16 rows and no scales."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((L, POS0, NKV, D)).astype(np.float32) * 0.5
    if kv == "bf16":
        c = np.zeros((L, S, NKV * D), jnp.bfloat16)
        c[:, :POS0] = rows.reshape(L, POS0, NKV * D).astype(jnp.bfloat16)
        return c, None
    q, s = jax.jit(_quantize_kv_rows)(jnp.asarray(rows))
    k = np.zeros((L, S, NKV * D), np.int8)
    ks = np.zeros((L, S, NKV), np.float32)
    k[:, :POS0] = np.asarray(q).reshape(L, POS0, NKV * D)
    ks[:, :POS0] = np.asarray(s)
    return k, ks


def _torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_step(mega, dcfg, x, pos, c):
    """One JAX kernel step -> (token, h, k, v, k_s, v_s) with the scales
    back in the port's [L, S, NKV] layout (None for bf16)."""
    k, v, ks, vs = c
    if ks is None:
        tok, k, v, h = jmk.mega_decode_step(mega, dcfg, x, jnp.int32(pos), k, v,
                                            interpret=True)
        return tok, h, k, v, None, None
    tok, k, v, ks, vs, h = jmk.mega_decode_step_i8(
        mega, dcfg, x, jnp.int32(pos), k, v, ks, vs, interpret=True)
    return tok, h, k, v, ks, vs


def _port_step(pack, dcfg, tok_or_x, pos, c):
    k, v, ks, vs = c
    if ks is None:
        return tmk.mega_decode_step(pack, dcfg, tok_or_x, pos, k, v)
    return tmk.mega_decode_step_i8(pack, dcfg, tok_or_x, pos, k, v, ks, vs)


def _jax_cache(k, ks, v, vs):
    tr = (lambda a: None if a is None else jnp.asarray(a.transpose(0, 2, 1)))
    return [jnp.asarray(k), jnp.asarray(v), tr(ks), tr(vs)]


def _fresh_rows_agree(got, want, pos, head_dim, layer0_only: bool):
    """got: the port's (k, v, k_s, v_s) torch tensors, want: the JAX ones
    (scales [L, NKV, S]); the rows at pos of every layer. int8: codes within
    one step everywhere, on at most 1% of entries (layer 0 only when
    layer0_only), scales rtol 1e-2. bf16: rtol 1e-2 (layer 0 only when
    layer0_only), and every value within 2/127 of its head row's largest
    magnitude: the largest difference the int8 rule admits (codes within one
    step of scale amax / 127 differ by less than two steps)."""
    rows = slice(0, 1) if layer0_only else slice(None)
    for name, g, w in (("k", got[0], want[0]), ("v", got[1], want[1])):
        if g.dtype == torch.bfloat16:
            a = g[:, pos].float().numpy()
            b = np.asarray(w)[:, pos].astype(np.float32)
            np.testing.assert_allclose(a[rows], b[rows], rtol=1e-2, err_msg=name)
            ha, hb = a.reshape(a.shape[0], -1, head_dim), b.reshape(b.shape[0], -1, head_dim)
            bound = (2 / 127) * np.abs(hb).max(axis=2, keepdims=True)
            assert (np.abs(ha - hb) <= bound).all(), name
            continue
        d = np.abs(g[:, pos].numpy().astype(int) - np.asarray(w)[:, pos].astype(int))
        assert d.max() <= 1, name
        assert (d[rows] > 0).mean() <= 0.01, name
    for g, w in ((got[2], want[2]), (got[3], want[3])):
        if g is not None:
            np.testing.assert_allclose(g[:, pos].numpy(), np.asarray(w)[:, :, pos],
                                       rtol=1e-2)


@pytest.mark.parametrize("weights,kv", MODES)
def test_twin_matches_jax_kernel(setup, weights, kv):
    dcfg, tree, megas, packs = setup
    k0, ks0 = _cache(dcfg, 1, kv)
    v0, vs0 = _cache(dcfg, 2, kv)
    jc = _jax_cache(k0, ks0, v0, vs0)
    tc = [_torch(a) for a in (k0, v0, ks0, vs0)]
    embd = tree["decoder"]["token_embd"]
    tok = 7
    for i in range(STEPS):
        pos = POS0 + i
        x = jnp.asarray(embd[tok][None])
        jtok, jh, *jc = _jax_step(megas[weights], dcfg, x, pos, jc)
        ttok, th = _port_step(packs[weights], port_config(dcfg),
                              torch.tensor([tok], dtype=torch.int32), pos, tc)
        assert int(ttok[0]) == int(jtok), f"step {i}"
        a, b = th.numpy(), np.asarray(jh)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 2e-2, i
        _fresh_rows_agree(tc, jc, pos, dcfg.head_dim, layer0_only=True)
        # rows before pos are untouched by the step
        assert torch.equal(tc[0][:, :POS0], _torch(k0)[:, :POS0])
        tok = int(jtok)


_JAX_LAYER_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q",
                   "wd_s", "norms", "lsc")
_PORT_LAYER_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q",
                    "wd_s", "attn_norm", "ffn_norm", "q_norm", "k_norm")


@pytest.mark.parametrize("weights,kv", MODES)
def test_twin_layers_match_jax_kernel(setup, weights, kv):
    """One step at POS0, layer by layer through one-layer packs, each fed
    the JAX kernel's hidden state: codes within +-1 on at most 1% (bf16
    rows within rtol 1e-2), h rel L2 < 1e-2."""
    dcfg, tree, megas, packs = setup
    dcfg1 = dataclasses.replace(dcfg, n_layers=1)
    k0, ks0 = _cache(dcfg, 1, kv)
    v0, vs0 = _cache(dcfg, 2, kv)
    x = np.asarray(tree["decoder"]["token_embd"][7][None])
    sl = (lambda a, l: None if a is None else a[l:l + 1])
    for l in range(dcfg.n_layers):
        jm = {k: (v[l:l + 1] if k in _JAX_LAYER_KEYS else v)
              for k, v in megas[weights].items()}
        tm = {k: (v[l:l + 1] if k in _PORT_LAYER_KEYS else v)
              for k, v in packs[weights].items()}
        one = [sl(a, l) for a in (k0, ks0, v0, vs0)]
        _, jh, *jc = _jax_step(jm, dcfg1, jnp.asarray(x), POS0, _jax_cache(*one))
        tc = [_torch(a) for a in (one[0], one[2], one[1], one[3])]
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        _, th = _port_step(tm, port_config(dcfg1), xt, POS0, tc)
        a, b = th.numpy(), np.asarray(jh)
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-2, l
        _fresh_rows_agree(tc, jc, POS0, dcfg.head_dim, layer0_only=False)
        x = np.asarray(jh).astype(jnp.bfloat16)


@pytest.mark.parametrize("weights,kv", MODES)
def test_twin_token_input_equals_row_input(setup, weights, kv):
    dcfg, tree, _, packs = setup
    k, ks = _cache(dcfg, 1, kv)
    v, vs = _cache(dcfg, 2, kv)
    base = [_torch(a) for a in (k, v, ks, vs)]
    pack = packs[weights]
    a = _port_step(pack, port_config(dcfg), torch.tensor([5], dtype=torch.int32), POS0,
                   [None if t is None else t.clone() for t in base])
    b = _port_step(pack, port_config(dcfg), pack["embd"][5][None], POS0,
                   [None if t is None else t.clone() for t in base])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_int8_pack_holds_the_int8pc_leaves(setup):
    """The int8 pack is the int8pc codes and per-column scales as they are,
    the head's vocab zero-padded to HEAD_PAD; the kind is read from the
    codes' dtype."""
    dcfg, tree, _, packs = setup
    pack, lay = packs["int8"], tree["decoder"]["layers"]
    assert tmk.weight_bits(pack) == 8 and tmk.weight_bits(packs["int4"]) == 4
    np.testing.assert_array_equal(pack["qkv_q"].numpy(), lay["wqkv"]["i8pc:q"])
    np.testing.assert_array_equal(pack["wd_s"].numpy(), lay["w_down"]["i8pc:s"])
    hq, V = pack["head_q"], dcfg.vocab_size
    assert hq.dtype == torch.int8 and hq.shape[1] % tmk.HEAD_PAD == 0
    np.testing.assert_array_equal(hq[:, :V].numpy(), tree["decoder"]["lm_head_pc"]["i8pc:q"])
    assert not hq[:, V:].any() and not pack["head_s"][V:].any()
