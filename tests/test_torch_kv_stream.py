"""Long context: the port's decode steps against the JAX package's
streamed-KV mode (`kv_stream=True`: K/V in 256-row KV_BLOCK tiles folded
with an online softmax, the mode its generate_greedy switches to past the
VMEM budget). The port has one attention path for every S (64-row chunks
merged by a combine step), so the same port functions are held against
the JAX package's other mode, at S = 512 (two KV_BLOCKs) and positions past
the first block:

- K1's twin (`mega_decode_step_i8` / `mega_decode_step` /
  `mega_decode_step_i4` on CPU tensors) on the int8 pack over the int8,
  bf16 and int4 caches vs `mega_decode_step{,_i8,_i4}(kv_stream=True)` in
  interpret mode: a whole step at an even pos, then each layer alone on
  the JAX kernel's hidden state at the next (odd) pos;
- K3's twin (`mega_decode_step_batch` on CPU tensors) over the int8 pool vs
  `mega_decode_step_batch(kv_stream=True)`, row by row.

Bounds are tests/test_torch_megakernel.py's (tokens equal; h relative L2
< 2e-2 after all layers, < 1e-2 for a layer alone; fresh int8 codes within
one step on at most 1% of entries, scales rtol 1e-2; bf16 rows rtol 1e-2
and within 2/127 of the head row's magnitude; each held on layer 0 of the
whole step and on every layer alone) and tests/test_torch_kv4.py's for the
int4 cache (codes equal but on at most 1 of a layer's 32, scales rtol
2e-2); K3's rows are held as tests/test_torch_megakernel_batch.py holds
them. The JAX package's block-major scales (`block_kv_scales`) are
unblocked to the port's [L, S, n_kv] for the comparison.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu.ops.megakernel_batch import mega_decode_step_batch as jax_batch_step
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb
from qwen3_asr_tpu_torch.runtime.params import from_jax_params
from test_torch_kv4 import codes, int4_cache, int8_rows
from test_torch_megakernel import _fresh_rows_agree
from test_torch_params import jax_tree, port_config

S = 2 * jmk.KV_BLOCK
POS0 = 300


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_asr_config()
    tree = jax_tree(cfg, seed=9)
    mega = jmk.pack_megakernel_params(tree["decoder"], cfg.decoder, int4=False)
    pack = from_jax_params(tree, port_config(cfg), int4=False)["decoder"]["mega"]
    return cfg.decoder, tree, mega, pack


def _caches(dcfg, kv):
    """(k, v, k_s, v_s) as numpy over S rows, rows < POS0 filled: int8 codes
    and scales, bf16 rows (scales None) or int4 pairs and scales."""
    if kv == "int4":
        (k, ks), (v, vs) = int4_cache(dcfg, POS0, 1, S), int4_cache(dcfg, POS0, 2, S)
        return k, v, ks, vs
    (k, ks), (v, vs) = int8_rows(dcfg, POS0, 1, S), int8_rows(dcfg, POS0, 2, S)
    if kv == "int8":
        return k, v, ks, vs
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim

    def deq(q, s):
        return (q.reshape(L, S, NKV, D) * s[..., None]).reshape(L, S, NKV * D).astype(
            jnp.bfloat16)

    return deq(k, ks), deq(v, vs), None, None


def _jax_step(mega, dcfg, x, pos, c, kv):
    """One JAX kv_stream step -> (token, h, [k, v, k_s, v_s]) as numpy, int4
    bytes as uint8, scales unblocked to [L, S, NKV]."""
    k, v, ks, vs = c
    args = [jnp.asarray(k.view(np.int8) if kv == "int4" else k), jnp.asarray(
        v.view(np.int8) if kv == "int4" else v)]
    if kv == "bf16":
        tok, k, v, h = jmk.mega_decode_step(mega, dcfg, x, jnp.int32(pos), *args,
                                            interpret=True, kv_stream=True)
        return int(tok), np.asarray(h), [np.asarray(k), np.asarray(v), None, None]
    fn = jmk.mega_decode_step_i4 if kv == "int4" else jmk.mega_decode_step_i8
    tok, k, v, ks, vs, h = fn(mega, dcfg, x, jnp.int32(pos), *args,
                              jmk.block_kv_scales(jnp.asarray(ks)),
                              jmk.block_kv_scales(jnp.asarray(vs)),
                              interpret=True, kv_stream=True)
    k, v = np.asarray(k), np.asarray(v)
    if kv == "int4":
        k, v = k.view(np.uint8), v.view(np.uint8)
    return int(tok), np.asarray(h), [k, v, np.asarray(jmk.unblock_kv_scales(ks)),
                                     np.asarray(jmk.unblock_kv_scales(vs))]


def _torch(c):
    return [None if a is None else torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            if a.dtype == jnp.bfloat16 else torch.from_numpy(a.copy()) for a in c]


def _port_step(pack, dcfg, tok_or_x, pos, tc, kv):
    if kv == "bf16":
        return tmk.mega_decode_step(pack, port_config(dcfg), tok_or_x, pos, *tc[:2])
    step = tmk.mega_decode_step_i4 if kv == "int4" else tmk.mega_decode_step_i8
    return step(pack, port_config(dcfg), tok_or_x, pos, *tc)


def _rows_agree(tc, jc, pos, dcfg, kv, layers):
    """The fresh rows at pos of `layers` (a slice): int4 codes equal but on
    at most 1 of a layer's 32 and scales rtol 2e-2; int8 / bf16 rows by
    tests/test_torch_megakernel.py's rule (within one code on at most 1%,
    scales rtol 1e-2; bf16 rows rtol 1e-2, within 2/127 of the head row's
    magnitude)."""
    if kv == "int4":
        for got, want in ((tc[0].numpy(), jc[0]), (tc[1].numpy(), jc[1])):
            d = codes(got, pos)[layers] != codes(want, pos)[layers]
            assert d.sum(axis=1).max() <= 1
        for g, w in ((tc[2], jc[2]), (tc[3], jc[3])):
            np.testing.assert_allclose(g[layers, pos].numpy(), w[layers, pos], rtol=2e-2)
        return
    tr = (lambda a: None if a is None else a[layers].transpose(0, 2, 1))
    _fresh_rows_agree([None if t is None else t[layers] for t in tc],
                      [jc[0][layers], jc[1][layers], tr(jc[2]), tr(jc[3])], pos,
                      dcfg.head_dim, layer0_only=False)


@pytest.mark.parametrize("kv", ["int8", "bf16", "int4"])
def test_k1_twin_matches_jax_kv_stream(setup, kv):
    """One whole step at pos 300 from token 7 (token equal, h rel L2 <
    2e-2, layer 0's fresh rows), then each layer alone at pos 301 (the odd
    row: the int4 cache's high nibble) on the JAX kernel's own hidden
    state (h rel L2 < 1e-2 and every layer's fresh rows)."""
    from test_torch_megakernel import _JAX_LAYER_KEYS, _PORT_LAYER_KEYS

    dcfg, tree, mega, pack = setup
    c = _caches(dcfg, kv)
    tc = _torch(c)
    x = jnp.asarray(tree["decoder"]["token_embd"][7][None])
    jt, jh, jc = _jax_step(mega, dcfg, x, POS0, [None if a is None else a.copy() for a in c],
                           kv)
    ttok, th = _port_step(pack, dcfg, torch.tensor([7], dtype=torch.int32), POS0, tc, kv)
    assert int(ttok[0]) == jt
    assert np.linalg.norm(th.numpy() - jh) / np.linalg.norm(jh) < 2e-2
    _rows_agree(tc, jc, POS0, dcfg, kv, slice(0, 1))
    dcfg1 = dataclasses.replace(dcfg, n_layers=1)
    pos, x = POS0 + 1, np.asarray(jh).astype(jnp.bfloat16)
    for l in range(dcfg.n_layers):
        jm = {n: (a[l:l + 1] if n in _JAX_LAYER_KEYS else a) for n, a in mega.items()}
        tm = {n: (a[l:l + 1] if n in _PORT_LAYER_KEYS else a) for n, a in pack.items()}
        one = [None if a is None else a[l:l + 1] for a in jc]
        _, jh, jc1 = _jax_step(jm, dcfg1, jnp.asarray(x), pos, one, kv)
        tc1 = _torch(one)
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
        _, th = _port_step(tm, dcfg1, xt, pos, tc1, kv)
        assert np.linalg.norm(th.numpy() - jh) / np.linalg.norm(jh) < 1e-2, l
        _rows_agree(tc1, jc1, pos, dcfg, kv, slice(None))
        x = np.asarray(jh).astype(jnp.bfloat16)


def test_k3_twin_matches_jax_kv_stream(setup):
    """B = 3 rows at positions on both sides of the first KV_BLOCK (and in
    its last chunk), two steps: each row's token, h and fresh int8 rows."""
    dcfg, tree, mega, pack = setup
    pos0 = (300, 100, 255)
    rows = [(int8_rows(dcfg, p, 10 + b, S), int8_rows(dcfg, p, 20 + b, S))
            for b, p in enumerate(pos0)]
    k, ks = (np.stack([r[0][i] for r in rows]) for i in range(2))
    v, vs = (np.stack([r[1][i] for r in rows]) for i in range(2))
    tc = [torch.from_numpy(a.copy()) for a in (k, v, ks, vs)]
    block = (lambda a: jnp.stack([jmk.block_kv_scales(jnp.asarray(s)) for s in a]))
    jk, jv, jks, jvs = jnp.asarray(k), jnp.asarray(v), block(ks), block(vs)
    embd = tree["decoder"]["token_embd"]
    toks = np.array([7, 100, 300])
    for i in range(2):
        pos = np.array(pos0) + i
        jt, jk, jv, jks, jvs, jh = jax_batch_step(
            mega, dcfg, jnp.asarray(embd[toks]), jnp.asarray(pos, jnp.int32), jk, jv, jks,
            jvs, interpret=True, kv_stream=True)
        tt, th = tmb.mega_decode_step_batch(pack, port_config(dcfg),
                                            torch.from_numpy(toks.astype(np.int32)), pos, *tc)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=str(i))
        uks = np.stack([np.asarray(jmk.unblock_kv_scales(s)) for s in jks])
        uvs = np.stack([np.asarray(jmk.unblock_kv_scales(s)) for s in jvs])
        for b in range(len(pos)):
            a, w = th[b].numpy(), np.asarray(jh)[b]
            assert np.linalg.norm(a - w) / np.linalg.norm(w) < 2e-2, (i, b)
            for got, want, gs, ws in ((tc[0], jk, tc[2], uks), (tc[1], jv, tc[3], uvs)):
                d = np.abs(got[b, :, pos[b]].numpy().astype(int)
                           - np.asarray(want)[b, :, pos[b]].astype(int))
                assert d[0].max() <= 1 and (d[0] > 0).mean() <= 0.01, (i, b)
                assert d.max() <= 2, (i, b)
                np.testing.assert_allclose(gs[b, :, pos[b]].numpy(), ws[b, :, pos[b]],
                                           rtol=1e-2)
        toks = np.asarray(jt)
