"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: skipped without an sm_90 device. This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows
from qwen3_asr_tpu_torch.ops import flash_attention as tfa
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.runtime import params as tparams

NEAR_TIE_TOL = 0.2  # scripts/chipgate.py: argmax flips below this logit gap


@pytest.fixture
def cuda_kernels():
    """Skips only without an sm_90 device; there, a library that does not
    build or load fails the test."""
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_sm90

    if not has_sm90():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    build.library()


@pytest.mark.cuda
@pytest.mark.parametrize("causal,T,NH,NKV,D,valid", [
    (True, 1280, 16, 8, 128, 1216), (False, 1196, 14, 14, 64, 1196),
    (True, 100, 4, 2, 64, 77)])
def test_flash_kernel_matches_twin(cuda_kernels, causal, T, NH, NKV, D, valid):
    """Both round f32 math to bf16 once, so they differ by at most one bf16
    ulp (< 2**-7 relative): atol 1e-3, rtol 1e-2 against the one-pass twin."""
    g = torch.Generator(device="cuda").manual_seed(T)
    q, k, v = (torch.randn(1, T, h, D, generator=g, device="cuda").to(torch.bfloat16)
               for h in (NH, NKV, NKV))
    vl = torch.tensor([valid], dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(D)
    before = tfa.flash_attention_batch.launches
    got = tfa.flash_attention_batch(q, k, v, vl, causal=causal, scale=scale)
    assert tfa.flash_attention_batch.launches == before + 1
    want = tfa.flash_attention_ref(q, k, v, vl, causal=causal, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=1e-2)


def _tiny_pack():
    cfg = tiny_asr_config()
    dec = tparams.init_asr_params(cfg, seed=3, device="cuda")["decoder"]
    dec = tparams.fuse_decoder_params(tparams.quantize_decoder_params(dec))
    return cfg.decoder, tmk.pack_megakernel_params(dec, cfg.decoder)


def _cache(dcfg, S, pos0, seed):
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, s = _quantize_kv_rows(torch.randn(L, pos0, NKV, D, generator=g,
                                         device="cuda") * 0.5)
    c = torch.zeros(L, S, NKV * D, dtype=torch.int8, device="cuda")
    sc = torch.zeros(L, S, NKV, dtype=torch.float32, device="cuda")
    c[:, :pos0] = q.reshape(L, pos0, NKV * D)
    sc[:, :pos0] = s
    return c, sc


@pytest.mark.cuda
@pytest.mark.parametrize("S,pos0", [(32, 12), (256, 150)])
def test_megakernel_matches_twin(cuda_kernels, S, pos0):
    """Teacher-forced over 4 steps: tokens equal or a near tie of the
    twin's logits; h atol/rtol 2e-2; every layer's fresh cache rows within
    one code on <= 1% of entries, their scales at rtol 1e-2.
    pos0 = 150 spreads the cache rows over three attention chunks."""
    dcfg, pack = _tiny_pack()
    k, ks = _cache(dcfg, S, pos0, 1)
    v, vs = _cache(dcfg, S, pos0, 2)
    ref = [t.clone() for t in (k, v, ks, vs)]
    step = tmk.DecodeStep(pack, dcfg, k, v, ks, vs)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    tok = torch.tensor([7], dtype=torch.int32, device="cuda")
    for i in range(4):
        step(tok, pos0 + i, out)
        rt, rh, logits = tmk.mega_decode_step_i8_ref(
            pack, dcfg, tok, pos0 + i, *ref, return_logits=True)
        got, want = int(out[0]), int(rt[0])
        assert got == want or float(logits[want] - logits[got]) <= NEAR_TIE_TOL
        torch.testing.assert_close(step.h, rh, atol=2e-2, rtol=2e-2)
        for a, b in ((k, ref[0]), (v, ref[1])):
            d = (a[:, pos0 + i].int() - b[:, pos0 + i].int()).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01
        for a, b in ((ks, ref[2]), (vs, ref[3])):
            torch.testing.assert_close(a[:, pos0 + i], b[:, pos0 + i],
                                       rtol=1e-2, atol=0)
        tok = rt.clone()


@pytest.mark.cuda
def test_megakernel_rejects_bad_arguments(cuda_kernels):
    dcfg, pack = _tiny_pack()
    k, ks = _cache(dcfg, 32, 12, 1)
    v, vs = _cache(dcfg, 32, 12, 2)
    step = tmk.DecodeStep(pack, dcfg, k, v, ks, vs)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        step(torch.tensor([7], dtype=torch.int32, device="cuda"), 32, out)
    with pytest.raises(TypeError):
        tmk.DecodeStep(pack, dcfg, k.float(), v, ks, vs)


@pytest.mark.cuda
def test_flash_kernel_batched_valid_lengths(cuda_kernels):
    """B = 4 with mixed valid lengths, causal and bidirectional: the same
    one-ulp bound as the single-item cases."""
    from qwen3_asr_tpu_torch.ops import flash_attention as tfa_mod

    g = torch.Generator(device="cuda").manual_seed(4)
    for causal, T, NH, NKV, D, valid in ((True, 200, 4, 2, 128, [200, 150, 64, 7]),
                                         (False, 190, 4, 4, 64, [190, 131, 100, 13])):
        q, k, v = (torch.randn(4, T, h, D, generator=g, device="cuda").to(torch.bfloat16)
                   for h in (NH, NKV, NKV))
        vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
        got = tfa_mod.flash_attention_batch(q, k, v, vl, causal=causal, scale=0.1)
        want = tfa_mod.flash_attention_ref(q, k, v, vl, causal=causal, scale=0.1)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=1e-2)


def _pool(dcfg, S, pos, seed):
    """[B, L, S, ...] caches with rows < pos[b] filled in slab b."""
    slabs = [(*_cache(dcfg, S, p, seed + 2 * b), *_cache(dcfg, S, p, seed + 2 * b + 1))
             for b, p in enumerate(pos)]
    k, ks, v, vs = (torch.stack([s[i] for s in slabs]) for i in range(4))
    return k, v, ks, vs


@pytest.mark.cuda
def test_batched_megakernel_rows_equal_single(cuda_kernels):
    """K3's rows equal K1 run on each row's slab copy, bit for bit (token,
    h, every layer's fresh K/V row and scales), over 4 teacher-forced
    steps at spread positions; and K3 against its plain version: tokens
    equal or a near tie, h atol/rtol 2e-2."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb

    dcfg, pack = _tiny_pack()
    S, pos0 = 256, [12, 150, 64, 199, 1]
    B = len(pos0)
    pool = _pool(dcfg, S, pos0, 10)
    singles = [[t[b].clone() for t in pool] for b in range(B)]
    ref = [t.clone() for t in pool]
    step = tmb.BatchDecodeStep(pack, dcfg, *pool)
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    toks = torch.tensor([7, 9, 11, 13, 15], dtype=torch.int32, device="cuda")
    before = tmb.mega_decode_step_batch.launches
    for i in range(4):
        pos = [p + i for p in pos0]
        pos_d = torch.tensor(pos, dtype=torch.int32, device="cuda")
        step(toks, pos_d, out, (min(pos), max(pos)))
        rt, rh = tmb.mega_decode_step_batch_ref(pack, dcfg, toks, pos, *ref)
        for b in range(B):
            k1 = tmk.DecodeStep(pack, dcfg, *singles[b])
            k1(toks[b:b + 1], pos[b], one)
            assert torch.equal(out[b:b + 1], one), (i, b)
            assert torch.equal(step.h[b:b + 1], k1.h), (i, b)
            for t, s in zip(pool, singles[b]):
                assert torch.equal(t[b, :, pos[b]], s[:, pos[b]]), (i, b)
        torch.testing.assert_close(step.h, rh, atol=2e-2, rtol=2e-2)
        for b in range(B):
            if int(out[b]) != int(rt[b]):
                _, _, lg = tmk.mega_decode_step_i8_ref(
                    pack, dcfg, toks[b:b + 1], pos[b], *[t[b].clone() for t in ref],
                    return_logits=True)
                assert float(lg[int(rt[b])] - lg[int(out[b])]) <= NEAR_TIE_TOL
        for a, r in zip(pool, ref):  # teacher-force the plain version's cache
            for b in range(B):
                r[b, :, pos[b]] = a[b, :, pos[b]]
        toks = rt.clone()
    assert tmb.mega_decode_step_batch.launches == before + 4


@pytest.mark.cuda
def test_batched_megakernel_rejects_bad_arguments(cuda_kernels):
    from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb

    dcfg, pack = _tiny_pack()
    pool = _pool(dcfg, 32, [12, 5], 1)
    step = tmb.BatchDecodeStep(pack, dcfg, *pool)
    out = torch.empty(2, dtype=torch.int32, device="cuda")
    toks = torch.tensor([7, 8], dtype=torch.int32, device="cuda")
    pos = torch.tensor([12, 5], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        step(toks, pos, out, (5, 32))
    with pytest.raises(ValueError):
        step(toks, pos, out, (0, 12))
    with pytest.raises(TypeError):
        tmb.BatchDecodeStep(pack, dcfg, pool[0].float(), *pool[1:])
    big = [t[:1].expand(17, *t.shape[1:]).contiguous() for t in pool]
    with pytest.raises(ValueError):
        tmb.BatchDecodeStep(pack, dcfg, *big)
