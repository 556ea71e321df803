"""The port's CUDA kernels vs their plain PyTorch twins, on the card.

Marked `cuda`: skipped without an sm_90 device. This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.config import tiny_asr_config
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


FLASH_CASES = [(D, causal, valid) for D in (64, 128) for causal in (True, False)
               for valid in (1, 77, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,causal,valid", FLASH_CASES,
                         ids=[f"D{d}-{'causal' if c else 'bidir'}-valid{v}"
                              for d, c, v in FLASH_CASES])
def test_flash_tensor_core_kernel_matches_twin(cuda_kernels, D, causal, valid):
    """K2 on the tensor cores at both head dims (D 64: 14 heads, no GQA, as
    the encoder; D 128: 16 q heads over 8 KV heads, as the decoder), causal
    and bidirectional, T = 200 (not a multiple of the 64-row tiles), valid
    lengths 1, 77 and T, in a batch of two with the second item's valid
    length T: atol 1e-3, rtol 1e-2 against the twin, as chip_smoke.py
    holds it."""
    T = 200
    NH, NKV = (14, 14) if D == 64 else (16, 8)
    g = torch.Generator(device="cuda").manual_seed(D + valid + int(causal))
    q, k, v = (torch.randn(2, T, h, D, generator=g, device="cuda").to(torch.bfloat16)
               for h in (NH, NKV, NKV))
    vl = torch.tensor([valid, T], dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(D)
    got = tfa.flash_attention_batch(q, k, v, vl, causal=causal, scale=scale)
    want = tfa.flash_attention_ref(q, k, v, vl, causal=causal, scale=scale)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=1e-2)


def _tiny_pack(int4: bool = True):
    cfg = tiny_asr_config()
    dec = tparams.init_asr_params(cfg, seed=3, device="cuda")["decoder"]
    dec = tparams.fuse_decoder_params(tparams.quantize_decoder_params(dec))
    return cfg.decoder, tmk.pack_megakernel_params(dec, cfg.decoder, int4=int4)


def _cache(dcfg, S, pos0, seed, kv="int8"):
    """Rows < pos0 filled: (int8 codes, f32 scales), (int4 pairs [L, S/2,
    DKV], f32 scales) or (bf16 rows, None)."""
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randn(L, pos0, NKV, D, generator=g, device="cuda") * 0.5
    if kv == "bf16":
        c = torch.zeros(L, S, NKV * D, dtype=torch.bfloat16, device="cuda")
        c[:, :pos0] = rows.reshape(L, pos0, NKV * D).to(torch.bfloat16)
        return c, None
    q, s = _quantize_kv_rows(rows)
    c = torch.zeros(L, S, NKV * D, dtype=torch.int8, device="cuda")
    sc = torch.zeros(L, S, NKV, dtype=torch.float32, device="cuda")
    c[:, :pos0] = q.reshape(L, pos0, NKV * D)
    sc[:, :pos0] = s
    return tmk.pack_kv_int4(c, sc) if kv == "int4" else (c, sc)


MODES = [(i4, kv) for i4 in (True, False) for kv in ("int8", "bf16", "int4")]
COUNTERS = {"int8": tmk.mega_decode_step_i8, "bf16": tmk.mega_decode_step,
            "int4": tmk.mega_decode_step_i4}


def _codes(c, pos):
    """Cache row pos of every layer as int codes [L, DKV] (int4 pairs
    unpacked)."""
    if c.dtype == torch.uint8:
        return tmk.unpack_nibbles(c[:, pos // 2:pos // 2 + 1])[:, pos % 2].int()
    return c[:, pos].int()


@pytest.mark.cuda
@pytest.mark.parametrize("int4,kv", MODES, ids=[f"{'int4' if a else 'int8'}-{b}"
                                                for a, b in MODES])
@pytest.mark.parametrize("S,pos0", [(32, 12), (256, 150)])
def test_megakernel_matches_twin(cuda_kernels, S, pos0, int4, kv):
    """K1 in its six modes, teacher-forced over 4 steps: tokens equal or a
    near tie of the twin's logits; h atol/rtol 2e-2; every layer's fresh
    cache rows within one code on <= 1% of entries, their scales at rtol
    1e-2 (int8 and int4 caches), or at rtol 1e-2 (bf16 rows); the int4
    cache's other bytes (the fresh row's neighbour nibble among them)
    unchanged. pos0 = 150 spreads the cache rows over three attention
    chunks; the steps write both nibbles of a byte row."""
    dcfg, pack = _tiny_pack(int4)
    k, ks = _cache(dcfg, S, pos0, 1, kv)
    v, vs = _cache(dcfg, S, pos0, 2, kv)
    ref = [None if t is None else t.clone() for t in (k, v, ks, vs)]
    step = tmk.DecodeStep(pack, dcfg, k, v, ks, vs)
    counter = COUNTERS[kv]
    before = counter.launches
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    tok = torch.tensor([7], dtype=torch.int32, device="cuda")
    for i in range(4):
        step(tok, pos0 + i, out)
        rt, rh, logits = tmk.mega_decode_step_ref(
            pack, dcfg, tok, pos0 + i, *ref, return_logits=True)
        got, want = int(out[0]), int(rt[0])
        assert got == want or float(logits[want] - logits[got]) <= NEAR_TIE_TOL
        torch.testing.assert_close(step.h, rh, atol=2e-2, rtol=2e-2)
        for a, b in ((k, ref[0]), (v, ref[1])):
            if kv == "bf16":   # within 2/127 of the head row's magnitude, as
                # tests/test_torch_megakernel.py holds bf16 rows
                ha = a[:, pos0 + i].float().reshape(dcfg.n_layers, -1, dcfg.head_dim)
                hb = b[:, pos0 + i].float().reshape(dcfg.n_layers, -1, dcfg.head_dim)
                bound = (2 / 127) * hb.abs().amax(dim=2, keepdim=True)
                assert bool(((ha - hb).abs() <= bound).all())
                continue
            d = (_codes(a, pos0 + i) - _codes(b, pos0 + i)).abs()
            assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 0.01
            if kv == "int4":   # the twin's copy takes the kernel's fresh nibble only
                r, lo = (pos0 + i) // 2, (pos0 + i) % 2 == 0
                b[:, r] = ((b[:, r] & 0xF0) | (a[:, r] & 0xF) if lo
                           else (a[:, r] & 0xF0) | (b[:, r] & 0xF))
        if kv != "bf16":
            for a, b in ((ks, ref[2]), (vs, ref[3])):
                torch.testing.assert_close(a[:, pos0 + i], b[:, pos0 + i],
                                           rtol=1e-2, atol=0)
        assert torch.equal(k[:, :pos0 // 2 if kv == "int4" else pos0],
                           ref[0][:, :pos0 // 2 if kv == "int4" else pos0])
        tok = rt.clone()
    if kv == "int4":
        assert torch.equal(k, ref[0]) and torch.equal(v, ref[1])
    assert counter.launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("int4,kv", MODES, ids=[f"{'int4' if a else 'int8'}-{b}"
                                                for a, b in MODES])
def test_graphed_steps_equal_eager(cuda_kernels, int4, kv):
    """K1 replayed from its CUDA graph (GraphStep, the decode loops' runner)
    against eager steps in each of the six modes: 64 free-running steps
    from the same token and cache; tokens and h torch.equal on every step,
    the caches torch.equal after the last (the int4 cache's byte rows
    whole); one launch counted per step either way."""
    dcfg, pack = _tiny_pack(int4)
    S, pos0, n = 256, 150, 64
    k, ks = _cache(dcfg, S, pos0, 1, kv)
    v, vs = _cache(dcfg, S, pos0, 2, kv)
    a = [k, v, ks, vs]
    b = [None if t is None else t.clone() for t in a]
    eager = tmk.DecodeStep(pack, dcfg, *a)
    run = tmk.GraphStep(tmk.DecodeStep(pack, dcfg, *b))
    counter = COUNTERS[kv]
    before = counter.launches
    toks = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    buf = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    toks[0] = buf[0] = 7
    for i in range(1, n + 1):
        eager(toks[i - 1:i], pos0 + i - 1, toks[i:i + 1])
        run(buf, i, pos0 + i - 1)
        assert torch.equal(toks[i], buf[i]), i
        assert torch.equal(eager.h, run.step.h), i
    assert run.graph is not None
    for x, y in zip(a, b):
        assert x is None or torch.equal(x, y)
    assert counter.launches == before + 2 * n


@pytest.mark.cuda
def test_graphed_steps_follow_a_new_buffer_and_position(cuda_kernels):
    """A GraphStep reused across buffers and positions (the streaming path's
    chunks): replays after a jump in position or a new token buffer equal
    the eager step on the same inputs."""
    dcfg, pack = _tiny_pack(False)
    S, pos0 = 256, 100
    a = [_cache(dcfg, S, pos0 + 40, 1, "bf16")[0], _cache(dcfg, S, pos0 + 40, 2, "bf16")[0],
         None, None]
    b = [None if t is None else t.clone() for t in a]
    eager = tmk.DecodeStep(pack, dcfg, *a)
    run = tmk.GraphStep(tmk.DecodeStep(pack, dcfg, *b))
    for pos, tok in ((pos0, 5), (pos0 + 1, 9), (pos0 + 30, 11), (pos0 + 31, 3)):
        want = torch.zeros(2, dtype=torch.int32, device="cuda")
        got = torch.zeros(2, dtype=torch.int32, device="cuda")
        want[0] = got[0] = tok
        eager(want[:1], pos, want[1:])
        run(got, 1, pos)
        assert torch.equal(want, got) and torch.equal(eager.h, run.step.h), pos
    assert all(x is None or torch.equal(x, y) for x, y in zip(a, b))


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


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [[2845], [2845, 1900, 950, 300]], ids=["B1", "B4"])
def test_flash_kernel_at_aligner_shape(cuda_kernels, valid):
    """The forced aligner's NAR pass: causal, T 2,944 (bench_align.py's
    2,845-row prompt bucketed to 128 rows), 16 q heads over 8 KV heads, D
    128, alone and in a batch of four valid lengths: the one-ulp bound of
    the other cases on every row, the padding rows past each valid length
    included (they attend only keys < valid)."""
    T, NH, NKV, D = 2944, 16, 8, 128
    g = torch.Generator(device="cuda").manual_seed(len(valid))
    q, k, v = (torch.randn(len(valid), T, h, D, generator=g, device="cuda").to(torch.bfloat16)
               for h in (NH, NKV, NKV))
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    scale = 1.0 / np.sqrt(D)
    before = tfa.flash_attention_batch.launches
    got = tfa.flash_attention_batch(q, k, v, vl, causal=True, scale=scale)
    assert tfa.flash_attention_batch.launches == before + 1
    want = tfa.flash_attention_ref(q, k, v, vl, causal=True, scale=scale)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=1e-2)


def _mid_aligner(quantize):
    """A forced aligner between the tiny and the full config (4-layer
    encoder at d 256, 4-layer decoder at hidden 512 with K2's D 128, 500
    classes), random weights on the card, a byte vocabulary; the classify
    head 8 times wider than the init, so most logit gaps clear the near-tie
    rule."""
    from qwen3_asr_tpu_torch.config import (
        AlignerModelConfig,
        AudioEncoderConfig,
        DecoderConfig,
    )
    from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
    from qwen3_asr_tpu_torch.text.bpe import _byte_to_unicode

    V = 2048
    cfg = AlignerModelConfig(
        encoder=AudioEncoderConfig(n_layers=4, d_model=256, n_heads=4, ffn_dim=1024,
                                   conv_channels=64, output_dim=512, n_window_infer=800),
        decoder=DecoderConfig(vocab_size=V, hidden_size=512, n_layers=4, n_heads=8,
                              n_kv_heads=4, head_dim=128, intermediate_size=1024,
                              classify_num=500, pad_token_id=0, eos_token_id=V - 1,
                              audio_start_token_id=V - 4, audio_end_token_id=V - 3,
                              audio_pad_token_id=V - 2),
        timestamp_token_id=V - 5)
    table = _byte_to_unicode()
    vocab = [table[b] for b in range(256)] + [f"[PAD{i}]" for i in range(256, V)]
    fa = ForcedAligner(quantize=quantize, device="cuda")
    fa.load_random(cfg, seed=0, vocab=vocab)
    fa.params["decoder"]["classify_w"] = fa.params["decoder"]["classify_w"] * 8
    return fa


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, "auto"], ids=["dense", "auto"])
def test_forced_aligner_matches_twins(cuda_kernels, quantize):
    """`ForcedAligner` on the card at a mid-size config against the same
    model with K2 swapped for its plain version: one K2 launch per decoder
    layer in an alignment (none in the windowed encoder), the classes at the
    <ts> rows equal wherever the twin's top-two logit gap is at least
    NEAR_TIE_TOL (most of them), and align, align fused and align_batch give
    words inside the audio."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models.decoder import classify_logits

    fa = _mid_aligner(quantize)
    rng = np.random.default_rng(0)
    t = np.arange(30 * 16000) / 16000
    audio = ((0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape))
             * 32767).astype(np.int16)
    text = " ".join(f"word{i:03d}" for i in range(60))
    before = tfa.flash_attention_batch.launches
    r = fa.align(audio, text)
    assert tfa.flash_attention_batch.launches == before + fa.cfg.decoder.n_layers
    for res in (r, fa.align(audio, text, fused=True),
                fa.align_batch([audio, audio[:80000]], [text, "a b c"])[0]):
        assert res.success and len(res.words) == 60
        assert all(0.0 <= w.start <= w.end <= 30.0 for w in res.words)

    mel, nf = fa.frontend(audio)
    feats, na = fa.encode(mel, nf)
    prompt, _ = fa.prompt(text, "", nf)
    ts = [i for i, tok in enumerate(prompt) if tok == fa.cfg.timestamp_token_id]

    def logits():
        h = fa.nar_pass([prompt], feats[None], [na])
        return classify_logits(fa.params["decoder"], fa.cfg.decoder, h[0, ts])

    got = logits()
    kernel = dmod.flash_attention_batch
    dmod.flash_attention_batch = tfa.flash_attention_ref
    try:
        want = logits()
    finally:
        dmod.flash_attention_batch = kernel
    top = want.topk(2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) >= NEAR_TIE_TOL
    assert sure.float().mean() > 0.5
    assert torch.equal(got.argmax(-1)[sure], want.argmax(-1)[sure])


def _pool(dcfg, S, pos, seed):
    """[B, L, S, ...] caches with rows < pos[b] filled in slab b."""
    slabs = [(*_cache(dcfg, S, p, seed + 2 * b), *_cache(dcfg, S, p, seed + 2 * b + 1))
             for b, p in enumerate(pos)]
    k, ks, v, vs = (torch.stack([s[i] for s in slabs]) for i in range(4))
    return k, v, ks, vs


# K3's batches: one 8-row MMA n-tile (5 rows), two of them (13: the second
# ragged, 16: both full); positions spread over the pool of S = 256
K3_POSITIONS = {5: [12, 150, 64, 199, 1],
                13: [12, 150, 64, 199, 1, 33, 240, 97, 5, 180, 128, 71, 220],
                16: [12, 150, 64, 199, 1, 33, 240, 97, 5, 180, 128, 71, 220, 2, 111, 250]}
K3_PARAMS = [(i4, B) for i4 in (True, False) for B in K3_POSITIONS]
K3_IDS = [f"{'int4' if i4 else 'int8'}-B{B}" for i4, B in K3_PARAMS]


@pytest.mark.cuda
@pytest.mark.parametrize("int4,B", K3_PARAMS, ids=K3_IDS)
def test_batched_megakernel_rows_equal_single(cuda_kernels, int4, B):
    """K3's rows equal K1 run on each row's slab copy, bit for bit (token,
    h, every layer's fresh K/V row and scales), over 4 teacher-forced
    steps at spread positions, on either pack, at B 5, 13 and 16 (rows 9-16
    in the products' second MMA n-tile); and K3 against its plain version:
    tokens equal or a near tie, h atol/rtol 2e-2."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb

    dcfg, pack = _tiny_pack(int4)
    S, pos0 = 256, K3_POSITIONS[B]
    pool = _pool(dcfg, S, pos0, 10)
    singles = [[t[b].clone() for t in pool] for b in range(B)]
    ref = [t.clone() for t in pool]
    step = tmb.BatchDecodeStep(pack, dcfg, *pool)
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    toks = torch.arange(7, 7 + 2 * B, 2, dtype=torch.int32, device="cuda")
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
                _, _, lg = tmk.mega_decode_step_ref(
                    pack, dcfg, toks[b:b + 1], pos[b], *[t[b].clone() for t in ref],
                    return_logits=True)
                assert float(lg[int(rt[b])] - lg[int(out[b])]) <= NEAR_TIE_TOL
        for a, r in zip(pool, ref):  # teacher-force the plain version's cache
            for b in range(B):
                r[b, :, pos[b]] = a[b, :, pos[b]]
        toks = rt.clone()
    assert tmb.mega_decode_step_batch.launches == before + 4


def _pool_bf16(dcfg, S, pos, seed):
    """[B, L, S, DKV] bf16 slabs with rows < pos[b] filled (no scales)."""
    k = torch.stack([_cache(dcfg, S, p, seed + 2 * b, "bf16")[0] for b, p in enumerate(pos)])
    v = torch.stack([_cache(dcfg, S, p, seed + 2 * b + 1, "bf16")[0]
                     for b, p in enumerate(pos)])
    return k, v


@pytest.mark.cuda
@pytest.mark.parametrize("int4,B", K3_PARAMS, ids=K3_IDS)
def test_batched_megakernel_bf16_rows_equal_k1_bf16(cuda_kernels, int4, B):
    """K3's bf16-cache mode: each row equals K1's bf16-cache step on that
    row's slab copy, bit for bit (token, h, every layer's fresh K/V row),
    over 4 teacher-forced steps at spread positions, at B 5, 13 and 16; the
    whole pool equal after them; against the plain version tokens equal or
    a near tie, h atol/rtol 2e-2."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb

    dcfg, pack = _tiny_pack(int4)
    S, pos0 = 256, K3_POSITIONS[B]
    pool = _pool_bf16(dcfg, S, pos0, 20)
    singles = [[t[b].clone() for t in pool] for b in range(B)]
    ref = [t.clone() for t in pool]
    step = tmb.BatchDecodeStep(pack, dcfg, *pool)
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    toks = torch.arange(7, 7 + 2 * B, 2, dtype=torch.int32, device="cuda")
    before = tmb.mega_decode_step_batch_bf16.launches, tmb.mega_decode_step_batch.launches
    for i in range(4):
        pos = [p + i for p in pos0]
        step(toks, torch.tensor(pos, dtype=torch.int32, device="cuda"), out,
             (min(pos), max(pos)))
        rt, rh = tmb.mega_decode_step_batch_ref(pack, dcfg, toks, pos, *ref, None, None)
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
                _, _, lg = tmk.mega_decode_step_ref(
                    pack, dcfg, toks[b:b + 1], pos[b], *[t[b].clone() for t in ref],
                    return_logits=True)
                assert float(lg[int(rt[b])] - lg[int(out[b])]) <= NEAR_TIE_TOL
        for a, r in zip(pool, ref):
            for b in range(B):
                r[b, :, pos[b]] = a[b, :, pos[b]]
        toks = rt.clone()
    for b in range(B):
        for t, s in zip(pool, singles[b]):
            assert torch.equal(t[b], s), b
    assert (tmb.mega_decode_step_batch_bf16.launches, tmb.mega_decode_step_batch.launches) \
        == (before[0] + 4, before[1])
    with pytest.raises(ValueError):
        tmb.BatchDecodeStep(pack, dcfg, *pool, pool[0].float(), None)


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


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(1024, 4096), (3072, 1024), (96, 192), (2048, 1088)])
@pytest.mark.parametrize("B", [1, 8, 13, 16])
def test_batch_product_equals_int_mm(cuda_kernels, K, N, B):
    """One of K3's products alone on the tensor cores: its int32 sums
    torch.equal to torch._int_mm's (q8_matmul.int8_matmul, rows padded),
    at the decoder's QKV and down shapes, a tiny one (one block row of 96
    input rows, a half tile of columns) and a ragged column count."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as tmb
    from qwen3_asr_tpu_torch.ops.q8_matmul import int8_matmul

    g = torch.Generator(device="cuda").manual_seed(K + N + B)
    xq = torch.randint(-127, 128, (B, K), generator=g, device="cuda",
                       dtype=torch.int32).to(torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    before = tmb.batch_product_i8.launches
    got = tmb.batch_product_i8(xq, w)
    assert torch.equal(got, int8_matmul(xq, w))
    assert tmb.batch_product_i8.launches == before + 1


def _q8_leaf(n_in, n_out, g, pad_out_to=1):
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    w = torch.randn(n_in, n_out, generator=g, device="cuda") * 0.02
    return q8.quant_leaf(w, pad_out_to=pad_out_to)


def _q8_close(got, want, bf16: bool):
    """f32 dequant: the same f32 products in another order (rel L2 < 1e-5);
    bf16 dequant: a normed activation may round to the other bf16 neighbour
    (rel L2 < 1e-4, |err| <= 1e-3 x the output's scale)."""
    rel = float((got - want).norm() / want.norm())
    assert rel < (1e-4 if bf16 else 1e-5), rel
    if bf16:
        assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4, 8, 16, 75])
def test_q8_kernels_match_twins(cuda_kernels, T):
    """K5 (Wo 2,048 -> 1,024), K6 (QKV 1,024 -> 4,096 and the lm head, 151,936
    columns padded to 155,648) and K7 (1,024 -> 2 x 3,072 -> 1,024) at the
    decode step's T = 1, the per-layer step's batches (4, 8, 16) and a 5 s
    prompt's T = 75."""
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(T, 1024, generator=g, device="cuda").to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(1024, generator=g, device="cuda")).to(torch.bfloat16)
    wo = _q8_leaf(2048, 1024, g)
    xa = torch.randn(T, 2048, generator=g, device="cuda").to(torch.bfloat16)
    before = q8.q8_matmul.launches
    _q8_close(q8.q8_matmul(xa, wo["q8:q"], wo["q8:s"]),
              q8.q8_matmul_ref(xa, wo["q8:q"], wo["q8:s"]), bf16=False)
    assert q8.q8_matmul.launches == before + 1
    for leaf in (_q8_leaf(1024, 4096, g), _q8_leaf(1024, 151936, g, pad_out_to=4096)):
        got = q8.q8_norm_matmul(x, leaf, nw, 1e-6)
        _q8_close(got, q8.q8_norm_matmul_ref(x, leaf["q8:q"], leaf["q8:s"], nw, 1e-6),
                  bf16=True)
    gu, dn = _q8_leaf(1024, 6144, g), _q8_leaf(3072, 1024, g)
    before = q8.q8_mlp.launches
    got = q8.q8_mlp(x, gu, dn, nw, 1e-6, 3072)
    assert q8.q8_mlp.launches == before + 1
    _q8_close(got, q8.q8_mlp_ref(x, gu["q8:q"], gu["q8:s"], dn["q8:q"], dn["q8:s"],
                                 nw, 1e-6, 3072), bf16=True)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 8, 16, 75])
def test_q8_mlp_matches_twin_on_its_own_act(cuda_kernels, T):
    """K7 at full width with the SwiGLU act's bf16 rounding taken out of the
    comparison: its gate-up launch sums what K6 sums on the fused gate|up
    leaf (the same body, split and order), so the act the kernel rounds is
    bf16(silu(g) * u) of K6's output; K7 against the twin's down product
    on that act is the same f32 products in another order (rel L2 < 1e-5).
    Against the whole twin a few act elements can round to the other bf16
    neighbour (test_q8_kernels_match_twins)."""
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(T, 1024, generator=g, device="cuda").to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(1024, generator=g, device="cuda")).to(torch.bfloat16)
    gu, dn = _q8_leaf(1024, 6144, g), _q8_leaf(3072, 1024, g)
    got = q8.q8_mlp(x, gu, dn, nw, 1e-6, 3072)
    sums = q8.q8_norm_matmul(x, gu, nw, 1e-6)
    gate, up = sums[:, :3072], sums[:, 3072:]
    act = (gate * (1.0 / (1.0 + torch.exp(-gate))) * up).to(torch.bfloat16)
    want = q8._matmul_f32(act, q8._deq_tile(dn["q8:q"], dn["q8:s"], True))
    _q8_close(got, want, bf16=False)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [2, 8, 16, 75])
def test_q8_rows_equal_one_row_launches(cuda_kernels, T):
    """K5 (Wo), K6 (QKV and the lm head) and K7 at full width: every row of a
    T-row launch torch.equal to the one-row launch on that row alone, and
    two launches on the same input equal (each output summed in one f32
    order, whatever T is: T 2 and 8 one row group, 16 a full one, 75 five
    groups, the last ragged)."""
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    g = torch.Generator(device="cuda").manual_seed(60 + T)
    x = torch.randn(T, 1024, generator=g, device="cuda").to(torch.bfloat16)
    xa = torch.randn(T, 2048, generator=g, device="cuda").to(torch.bfloat16)
    nw = (1 + 0.1 * torch.randn(1024, generator=g, device="cuda")).to(torch.bfloat16)
    wo, qkv = _q8_leaf(2048, 1024, g), _q8_leaf(1024, 4096, g)
    head = _q8_leaf(1024, 151936, g, pad_out_to=4096)
    gu, dn = _q8_leaf(1024, 6144, g), _q8_leaf(3072, 1024, g)
    for name, xx, fn in (
            ("K5 Wo", xa, lambda v: q8.q8_matmul(v, wo["q8:q"], wo["q8:s"])),
            ("K6 QKV", x, lambda v: q8.q8_norm_matmul(v, qkv, nw, 1e-6)),
            ("K6 lm head", x, lambda v: q8.q8_norm_matmul(v, head, nw, 1e-6)),
            ("K7", x, lambda v: q8.q8_mlp(v, gu, dn, nw, 1e-6, 3072))):
        got = fn(xx)
        assert torch.equal(got, fn(xx)), name
        for t in range(T):
            assert torch.equal(got[t:t + 1], fn(xx[t:t + 1])), (name, t)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("offset", [0, 1, 63, 64, 65, 1248, 1663])
def test_decode_attention_matches_twin(cuda_kernels, quant, offset):
    """K4 at the decoder's widths (16 q / 8 kv heads, D = 128), S = 1,664:
    the same f32 math in another order, rtol 1e-4 and atol 1e-5 x scale;
    one kernel a call (a call captured in a CUDA graph has one kernel
    node), two launches with the same bits, and the in-kernel store
    (store=True) torch.equal to store_kv_rows (what _store runs) at offsets
    around the 64-row chunk edges."""
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

    g = torch.Generator(device="cuda").manual_seed(offset + quant)
    S = 1664
    qkv = torch.randn(1, 4096, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(S, 8, 128, generator=g, device="cuda")
    v = torch.randn(S, 8, 128, generator=g, device="cuda")
    kw = dict(n_heads=16, n_kv=8, head_dim=128, eps=1e-6, theta=1e6,
              scale=1 / np.sqrt(128))
    if quant:
        (k, ks), (v, vs) = _quantize_kv_rows(k), _quantize_kv_rows(v)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    qn = (1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
    before = da.decode_attention.launches
    got = da.decode_attention(qkv, k, v, qn, qn, offset, offset, **kw)
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_ref(qkv, k, v, qn, qn, offset, offset, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))
    for a, b in zip(got, da.decode_attention(qkv, k, v, qn, qn, offset, offset, **kw)):
        assert torch.equal(a, b)
    assert kernels_a_call(lambda: da.decode_attention(qkv, k, v, qn, qn, offset, offset,
                                                      **kw, store=True)) == 1
    caches = {"k": k, "v": v, **({"k_s": ks, "v_s": vs} if quant else {})}
    one = {n: x for n, x in kw.items() if n not in ("k_scale", "v_scale")}
    da.check_store(
        "K4 store",
        lambda c, st: da.decode_attention(qkv, c["k"], c["v"], qn, qn, offset, offset, **one,
                                          k_scale=c.get("k_s"), v_scale=c.get("v_s"),
                                          store=st),
        caches, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_batch_rows_equal_one_row(cuda_kernels, quant):
    """K4's batched mode at the decoder's widths, S = 1,664, 8 rows at
    spread offsets (0, chunk edges, S - 1; one row roped past its offset):
    each row torch.equal to the one-row launch on its slab, all rows
    against the twin at K4's tolerance, one launch for the batch and one
    kernel (the kernel nodes of a captured call); a grid bound of S, and
    the slabs as layer 1 of a [B, 3, S, ...] pool (the batched decode's
    layout: slabs 3 S rows apart), give the same bits; the in-kernel store
    into that pool (row b at offsets[b] of its slab, S - 1 the last)
    torch.equal to store_kv_rows (what _store runs), the pool's other layers
    untouched; with the store on, a bound of S raises."""
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

    g = torch.Generator(device="cuda").manual_seed(40 + quant)
    S, offs = 1664, [0, 1, 63, 64, 65, 700, 1248, 1663]
    B = len(offs)
    pos = [o + (5 if b == 5 else 0) for b, o in enumerate(offs)]
    qkv = torch.randn(B, 4096, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, S, 8, 128, generator=g, device="cuda")
    v = torch.randn(B, S, 8, 128, generator=g, device="cuda")
    kw = dict(n_heads=16, n_kv=8, head_dim=128, eps=1e-6, theta=1e6,
              scale=1 / np.sqrt(128))
    if quant:
        (k, ks), (v, vs) = _quantize_kv_rows(k), _quantize_kv_rows(v)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    qn = (1 + 0.1 * torch.randn(128, generator=g, device="cuda")).to(torch.bfloat16)
    od = torch.tensor(offs, dtype=torch.int32, device="cuda")
    pd = torch.tensor(pos, dtype=torch.int32, device="cuda")
    before = da.decode_attention_batch.launches
    got = da.decode_attention_batch(qkv, k, v, qn, qn, od, pd, max(offs), **kw)
    assert da.decode_attention_batch.launches == before + 1
    again = da.decode_attention_batch(qkv, k, v, qn, qn, od, pd, S, **kw)
    want = da.decode_attention_batch_ref(qkv, k, v, qn, qn, offs, pos, **kw)

    def pool_of(t):
        pool = torch.zeros(B, 3, *t.shape[1:], dtype=t.dtype, device="cuda")
        pool[:, 1] = t
        return pool

    def in_pool(t):
        return pool_of(t)[:, 1]

    pkw = dict(kw, k_scale=in_pool(kw["k_scale"]), v_scale=in_pool(kw["v_scale"])) \
        if quant else kw
    pooled = da.decode_attention_batch(qkv, in_pool(k), in_pool(v), qn, qn, od, pd,
                                       max(offs), **pkw)
    for a, r, a2, a3 in zip(got, want, again, pooled):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * float(r.abs().max()))
        assert torch.equal(a, a2) and torch.equal(a, a3)
    for b in range(B):
        one_kw = dict(kw, k_scale=kw["k_scale"][b], v_scale=kw["v_scale"][b]) if quant else kw
        single = da.decode_attention(qkv[b:b + 1], k[b], v[b], qn, qn, offs[b], pos[b],
                                     **one_kw)
        for a, s1 in zip(got, single):
            assert torch.equal(a[b:b + 1], s1), b
    assert kernels_a_call(lambda: da.decode_attention_batch(qkv, k, v, qn, qn, od, pd,
                                                            max(offs), **kw,
                                                            store=True)) == 1
    with pytest.raises(ValueError, match="store=True"):
        da.decode_attention_batch(qkv, k, v, qn, qn, od, pd, S, **kw, store=True)
    pool = {n: pool_of(t) for n, t in (("k", k.flatten(-2)), ("v", v.flatten(-2)),
                                       *((("k_s", ks), ("v_s", vs)) if quant else ()))}
    bkw = {n: x for n, x in kw.items() if n not in ("k_scale", "v_scale")}

    def layer1(c, st):
        return da.decode_attention_batch(
            qkv, c["k"][:, 1].unflatten(-1, (8, 128)), c["v"][:, 1].unflatten(-1, (8, 128)),
            qn, qn, od, pd, max(offs), **bkw, k_scale=c["k_s"][:, 1] if quant else None,
            v_scale=c["v_s"][:, 1] if quant else None, store=st)

    da.check_store("K4 batched store", layer1, pool,
                   (torch.arange(B, device="cuda"), od.long()), view=lambda t: t[:, 1])


def _step_batch_and_singles(kv):
    """The per-layer step at B = 3 rows on the tiny config's Q8_0 leaves (K6 /
    K5 / K7 at T = 3, K4 batched) and the single step on each row's cache
    copy. -> (pos, the batched cache, h [B, hidden], [(single cache, h [1,
    hidden])])."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    cfg = tiny_asr_config()
    dec = tparams.init_asr_params(cfg, seed=3, device="cuda")["decoder"]
    dec = tparams.fuse_decoder_params(tparams.quantize_decoder_params(dec, "q8_0"))
    dcfg = cfg.decoder
    pos = [5, 40, 17]
    B, S = len(pos), 64
    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(9)
    cdt = torch.int8 if kv == "int8" else torch.bfloat16
    cache = {n: torch.zeros(B, L, S, NKV * D, dtype=cdt, device="cuda") for n in ("k", "v")}
    if kv == "int8":
        cache.update({n: torch.zeros(B, L, S, NKV, device="cuda") for n in ("k_s", "v_s")})
    for b, p in enumerate(pos):
        for n in ("k", "v"):
            rows = torch.randn(L, p, NKV, D, generator=g, device="cuda") * 0.5
            if kv == "int8":
                q, sc = _quantize_kv_rows(rows)
                cache[n][b, :, :p], cache[n + "_s"][b, :, :p] = q.flatten(2), sc
            else:
                cache[n][b, :, :p] = rows.flatten(2).to(torch.bfloat16)
    singles = [{n: (t[b].unflatten(-1, (NKV, D)) if n in ("k", "v") else t[b]).clone()
                for n, t in cache.items()} for b in range(B)]
    x = (torch.randn(B, dcfg.hidden_size, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
    h = dmod.decode_step_batch(dec, dcfg, x, cache,
                               torch.tensor(pos, dtype=torch.int32, device="cuda"), pos)
    rows = [(singles[b], dmod.decoder_forward(dec, dcfg, x[b:b + 1], singles[b], p + 1,
                                              prefill=False, cache_offset=p))
            for b, p in enumerate(pos)]
    return pos, cache, h, rows


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_batch_near_single_rows(cuda_kernels, kv):
    """The per-layer step at B rows (Q8_0 leaves: K6 / K5 / K7 at T = B, K4
    batched) against the single step on each row's cache copy: h rel L2 <
    1e-2 and every slab's other rows untouched."""
    pos, cache, h, rows = _step_batch_and_singles(kv)
    for b, (p, (single, hs)) in enumerate(zip(pos, rows)):
        assert float((h[b] - hs[0]).float().norm() / hs[0].float().norm()) < 1e-2, b
        for n, t in cache.items():
            assert torch.equal(t[b, :, :p], single[n].flatten(2)[:, :p])
            assert not t[b, :, p + 1:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_batch_rows_equal_single(cuda_kernels, kv):
    """The same batched step, held bit for bit: every row of h torch.equal to
    the single step's, and every slab torch.equal to its single cache
    (the fresh row included), since K5-K7 sum each output in one order
    whatever T is and K4's batched rows are its one-row launches."""
    pos, cache, h, rows = _step_batch_and_singles(kv)
    for b, (p, (single, hs)) in enumerate(zip(pos, rows)):
        assert torch.equal(h[b:b + 1], hs), b
        for n, t in cache.items():
            assert torch.equal(t[b], single[n].flatten(2) if n in ("k", "v") else single[n]), \
                (b, n)


@pytest.mark.cuda
def test_microbench_kernels_match_twins(cuda_kernels):
    """K9-K11 at a small stream (6 chunks of [1024, 256]): the integer modes
    and the unpack probe equal their twins exactly; bf16_m8 within 1e-6 of
    the twin's largest magnitude (f32 sums in another order)."""
    from qwen3_asr_tpu_torch import microbench_stream as mb

    d = mb.make_data(6, 256, "cuda", seed=3)
    for mode in mb.MODES:
        fn, ref = mb.runner(mode, d)
        wrappers = (mb.stream_read, mb.stream_read_ring, mb.stream_gemv,
                    mb.stream_gemv_i4, mb.unpack_probe)
        before = sum(w.launches for w in wrappers)
        got, want = fn().clone(), ref()
        assert sum(w.launches for w in wrappers) == before + 1, mode
        assert mb.max_err(mode, got, want) <= mb.tolerance(mode, want), mode
        if mode != "bf16_m8":   # the cross-block scratch is left zero for the next call
            assert torch.equal(fn(), got), mode



@pytest.mark.cuda
@pytest.mark.parametrize("int4,kv", MODES, ids=[f"{'int4' if a else 'int8'}-{b}"
                                                for a, b in MODES])
def test_graphed_sampled_steps_take_the_callers_token(cuda_kernels, int4, kv):
    """GraphStep(own_tokens=False), the sampled loop's runner, in each of
    the six modes: the caller overwrites out[i] after every step with a
    token of its own (not K1's argmax); 32 replays equal eager steps fed the
    same tokens, h and the caches torch.equal. The greedy runner's shortcut
    (own_tokens=True) in the same loop would feed K1's argmax instead: its
    h differs from the third step on, where its replays stop copying their
    input in (the planted fault this mode exists for)."""
    dcfg, pack = _tiny_pack(int4)
    S, pos0, n = 256, 150, 32
    k, ks = _cache(dcfg, S, pos0, 1, kv)
    v, vs = _cache(dcfg, S, pos0, 2, kv)
    a = [k, v, ks, vs]
    b = [None if t is None else t.clone() for t in a]
    c = [None if t is None else t.clone() for t in a]
    eager = tmk.DecodeStep(pack, dcfg, *a)
    run = tmk.GraphStep(tmk.DecodeStep(pack, dcfg, *b), own_tokens=False)
    shortcut = tmk.GraphStep(tmk.DecodeStep(pack, dcfg, *c))
    toks = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    buf, buf2 = toks.clone(), toks.clone()
    toks[0] = buf[0] = buf2[0] = 7
    differs = 0
    for i in range(1, n + 1):
        eager(toks[i - 1:i], pos0 + i - 1, toks[i:i + 1])
        run(buf, i, pos0 + i - 1)
        shortcut(buf2, i, pos0 + i - 1)
        assert torch.equal(eager.h, run.h), i
        differs += not torch.equal(eager.h, shortcut.h)
        mine = (toks[i:i + 1] + 1 + i) % dcfg.vocab_size   # the caller's token
        toks[i:i + 1] = buf[i:i + 1] = buf2[i:i + 1] = mine
    for x, y in zip(a, b):
        assert x is None or torch.equal(x, y)
    assert differs == n - 2


def _mid_models():
    """A decoder between the tiny and the full config (4 layers at hidden
    512, head_dim 128, vocab 2,048: the int8pc products' cuBLAS int8 GEMMs
    take no narrower widths) with its int8 decode pack, on the card, and a
    48-token prompt."""
    import dataclasses

    from qwen3_asr_tpu_torch.config import DecoderConfig

    V = 2048
    cfg = dataclasses.replace(tiny_asr_config(), decoder=DecoderConfig(
        vocab_size=V, hidden_size=512, n_layers=4, n_heads=8, n_kv_heads=4, head_dim=128,
        intermediate_size=1024, pad_token_id=0, eos_token_id=V - 1,
        audio_start_token_id=V - 4, audio_end_token_id=V - 3, audio_pad_token_id=V - 2))
    dec = tparams.init_asr_params(cfg, seed=3, device="cuda")["decoder"]
    dec = tparams.fuse_decoder_params(tparams.quantize_decoder_params(dec))
    dec["mega"] = tmk.pack_megakernel_params(dec, cfg.decoder, int4=False)
    g = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, V - 10, (48,), generator=g, device="cuda", dtype=torch.int32)
    return cfg.decoder, dec, toks


@pytest.mark.cuda
def test_generate_sample_graphed_equals_eager(cuda_kernels):
    """generate_sample on the card (K1 replayed from its graph, its h_out
    through the int8pc head, the drawn token fed back) equals the same loop
    run eagerly: DecodeStep per step, lm_logits(h), sample_from_logits on
    uniforms drawn per step from the seeded generator; a seed gives the
    same tokens twice."""
    from qwen3_asr_tpu_torch.models import generate as gen
    from qwen3_asr_tpu_torch.models.decoder import lm_logits

    dcfg, dec, toks = _mid_models()
    n_prompt, max_tokens = 40, 24
    kw = dict(temperature=1.0, top_k=40, top_p=0.9)
    got, n = gen.generate_sample(dec, dcfg, toks, n_prompt, None, 0, 0, max_tokens, seed=3,
                                 **kw)
    again, _ = gen.generate_sample(dec, dcfg, toks, n_prompt, None, 0, 0, max_tokens, seed=3,
                                   **kw)
    assert n == max_tokens and (got == again).all()
    g = torch.Generator(device="cuda").manual_seed(3)
    S = gen.cache_rows(toks.shape[0], max_tokens)
    h, cache = gen.prefill_hidden(dec, dcfg, toks, n_prompt, None, 0, 0, S, torch.bfloat16)
    step = tmk.DecodeStep(dec["mega"], dcfg, *gen.mega_caches(dcfg, cache, torch.bfloat16))
    out = torch.zeros(max_tokens, dtype=torch.int32, device="cuda")
    def pick(h):
        logits = lm_logits(dec, dcfg, h)
        return gen.sample_from_logits(
            logits, torch.rand(logits.shape, device="cuda", generator=g), **kw)

    out[:1] = pick(h)
    for i in range(1, max_tokens):
        step(out[i - 1:i], n_prompt + i - 1, out[i:i + 1])
        out[i:i + 1] = pick(step.h[0])
    assert out.cpu().tolist() == got.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
def test_spec_on_card_equals_int8pc_greedy(cuda_kernels, k):
    """generate_greedy_spec on the card (drafts from K1's graph, the verify
    pass on the int8pc leaves) against the per-layer int8pc greedy loop over
    an int8 cache on the card: equal at k = 1; at k 3 and 8 equal up to the
    first difference, a near tie in the reference's logits; the stats add
    up."""
    from qwen3_asr_tpu_torch.models import generate as gen

    dcfg, dec, toks = _mid_models()
    n_prompt, max_tokens = 40, 20
    vparams = {key: val for key, val in dec.items() if key != "mega"}
    S = gen.cache_rows(toks.shape[0], max_tokens)
    h, cache = gen.prefill_hidden(vparams, dcfg, toks, n_prompt, None, 0, 0, S, torch.int8)
    ref = torch.zeros(max_tokens, dtype=torch.int32, device="cuda")
    from qwen3_asr_tpu_torch.models.decoder import lm_logits

    logits = [lm_logits(vparams, dcfg, h)]
    ref[0] = torch.argmax(logits[0])
    logits += [gen.decode_token(vparams, dcfg, cache, ref, i, n_prompt + i - 1)
               for i in range(1, max_tokens)]
    ref = ref.cpu().tolist()
    before = tmk.mega_decode_step_i8.launches
    out, n, st = gen.generate_greedy_spec(dec, dcfg, toks, n_prompt, None, 0, 0,
                                          max_tokens, k=k)
    assert n == max_tokens and st["drafted"] == k * st["rounds"]
    assert tmk.mega_decode_step_i8.launches == before + st["drafted"]
    got = out[:n].tolist()
    diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if k == 1:
        assert not diff
    elif diff:
        j = diff[0]
        assert abs(float(logits[j][ref[j]] - logits[j][got[j]])) <= NEAR_TIE_TOL


def _wide_int8pc(n_layers: int, lm_head: bool = False):
    """The 0.6B decoder's widths at n_layers, random weights on the card,
    int8pc leaves (and the int8 lm head with lm_head), bf16."""
    import dataclasses

    from qwen3_asr_tpu_torch.config import ASRModelConfig

    cfg = dataclasses.replace(ASRModelConfig().decoder, n_layers=n_layers)
    dec = tparams.init_decoder_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                                      torch.bfloat16, "cuda")
    dec = tparams.quantize_decoder_params(dec, "int8pc", lm_head=lm_head)
    return cfg, tparams.fuse_decoder_params(dec)


def _prompt_rows(cfg, dec, B, P, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device="cuda")
    valid = torch.tensor([max(1, P - 9 * b) for b in range(B)], dtype=torch.int32,
                         device="cuda")
    return dec["token_embd"][tok], valid


def _bf16_moved(a, b) -> float:
    """The share of bf16 values of a that differ from b's."""
    return float((a.contiguous().view(torch.int16) != b.contiguous().view(torch.int16))
                 .float().mean())


# A normed pass's kernel sums its f32 squares in another order than torch's
# reduction, which can round a bf16 value the other way: at most this share
# of its codes (of q's and k's values) may move, by one step. An H100 reads
# at most 1.1e-5 at the 0.6B widths; a kernel with one of the chain's bf16
# roundings skipped moves 4e-2 or more (tests/test_torch_chip_faults.py).
PF_MOVED = 1e-4
# A layer alone on the eager input: a moved code moves a whole row of its
# product, so the layer's k rows move more (an H100 reads 1.1e-3).
PF_LAYER_K_MOVED = 5e-3


def _norm_weights(lay, g) -> dict:
    """Layer 0's norm weights as 1 + N(0, 0.25) in bf16: the random model's
    are ones, under which a dropped rounding of x * r before * w shows no
    difference."""
    return {n: (1 + 0.5 * torch.randn(lay[n][0].shape, generator=g, device="cuda"))
            .to(torch.bfloat16) for n in ("attn_norm", "ffn_norm", "q_norm", "k_norm")}


@pytest.mark.cuda
@pytest.mark.parametrize("B,P", [(1, 80), (1, 1280), (3, 100)], ids=["T80", "T1280", "B3xP100"])
def test_prefill_fused_kernels_match_twins(cuda_kernels, B, P):
    """The four fused passes of the int8pc prefill against their twins
    (torch's ops on the card) on layer 0 of the 0.6B widths: the passes
    without a norm (the attention output's codes, the SwiGLU's codes, every
    residual, v) bit for bit; those with one (the layer's RMSNorm codes, q
    and k after their per-head norm, with norm weights other than ones) at
    most PF_MOVED of codes / values one step off, the only freedom being the
    order of the f32 sum of squares. One launch a call; padding rows of the
    codes stay zero."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops import prefill_fused as pf
    from qwen3_asr_tpu_torch.ops.q8_matmul import int8_matmul

    cfg, dec = _wide_int8pc(1)
    lay, eps = dec["layers"], cfg.rms_norm_eps
    NH, NKV, D, F, H = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.intermediate_size,
                        cfg.hidden_size)
    h, valid = _prompt_rows(cfg, dec, B, P, P + B)
    N = B * P
    x = h.reshape(N, H)
    w = {n: dmod._leaf(lay, n, 0) for n in dmod._PC_MATRICES}
    nw = _norm_weights(lay, torch.Generator(device="cuda").manual_seed(P))
    inv_freq = dmod.rope_inv_freq(D, cfg.rope_theta, x.device)

    def bufs(n):
        return pf.codes_buffer(N, n, "cuda"), torch.empty(N, 1, device="cuda")

    def both(name, call, n, normed):
        fn = getattr(pf, name)
        got, want = bufs(n), bufs(n)
        before = fn.launches
        rg = call(fn, *got)
        assert fn.launches == before + 1
        rw = call(getattr(pf, name + "_ref"), *want)
        if rg is not None:
            assert torch.equal(rg, rw), name
        assert not got[0][N:].any()
        d = (got[0][:N].int() - want[0][:N].int()).abs()
        if normed:
            assert float((d != 0).float().mean()) <= PF_MOVED and int(d.max()) <= 1, name
            torch.testing.assert_close(got[1], want[1], rtol=1e-2, atol=0)
        else:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
        return want

    xq, sx = both("norm_quant_rows", lambda f, c, s: f(x, nw["attn_norm"], eps, c, s),
                  H, True)
    args = (int8_matmul(xq, w["wqkv"]["i8pc:q"]), sx, w["wqkv"]["i8pc:s"], nw["q_norm"],
            nw["k_norm"], P, NH, NKV, D, eps, inv_freq)
    before = pf.qkv_epilogue.launches
    q, k, v = pf.qkv_epilogue(*args)
    assert pf.qkv_epilogue.launches == before + 1
    q_ref, k_ref, v_ref = pf.qkv_epilogue_ref(*args)
    assert torch.equal(v, v_ref)
    for got, want in ((q, q_ref), (k, k_ref)):
        # a normed value one bf16 step off, then rotated: within a step of
        # the head's largest values
        assert _bf16_moved(got, want) <= PF_MOVED
        assert float((got.float() - want.float()).abs().max()) <= \
            2 ** -6 * float(want.float().abs().max())
    attn = tfa.flash_attention_batch(q_ref, k_ref, v_ref, valid, causal=True,
                                     scale=1.0 / float(np.sqrt(D))).reshape(N, NH * D)
    aq, asx = both("norm_quant_rows", lambda f, c, s: f(attn, None, eps, c, s), NH * D, False)
    acc = int8_matmul(aq, w["wo"]["i8pc:q"])
    fq_in = both("residual_norm_quant", lambda f, c, s: f(
        x, acc, asx, w["wo"]["i8pc:s"], nw["ffn_norm"], eps, c, s), H, True)
    acc_gu = int8_matmul(fq_in[0], w["w_gate_up"]["i8pc:q"])
    both("swiglu_quant", lambda f, c, s: f(acc_gu, fq_in[1], w["w_gate_up"]["i8pc:s"], F,
                                           c, s), F, False)
    # the last layer's pass: the residual alone, its codes untouched
    got, want = bufs(H), bufs(H)
    assert torch.equal(pf.residual_norm_quant(x, acc, asx, w["wo"]["i8pc:s"], None, eps, *got),
                       pf.residual_norm_quant_ref(x, acc, asx, w["wo"]["i8pc:s"], None, eps,
                                                  *want))
    assert not got[0].any()


@pytest.mark.cuda
def test_prefill_fused_stack_matches_eager(cuda_kernels, monkeypatch):
    """`_prefill_layers` at the 0.6B widths and depth, fused against the
    eager chain from one 730-row prompt: each layer alone on the eager
    input within rel L2 1e-2 (at most PF_LAYER_K_MOVED of its k rows'
    values moved), the whole stack's first greedy token equal, 28 fused
    layers counted; under set_sync_debug_mode("error") the fused stack
    makes no host-device sync."""
    import dataclasses

    from qwen3_asr_tpu_torch.models import decoder as dmod

    cfg, dec = _wide_int8pc(28, lm_head=True)
    h, valid = _prompt_rows(cfg, dec, 1, 730, 1)
    P = h.shape[1]
    valid[0] = P

    def eager(fn):
        with monkeypatch.context() as m:
            m.setattr(dmod, "_fusable", lambda *a: False)
            return fn()

    cfg1 = dataclasses.replace(cfg, n_layers=1)
    x = h
    for l in range(cfg.n_layers):
        d1 = dict(dec, layers={n: ({a: b[l:l + 1] for a, b in t.items()}
                                   if isinstance(t, dict) else t[l:l + 1])
                               for n, t in dec["layers"].items()})
        rows, erows = [], []
        got = dmod._prefill_layers(d1, cfg1, x, valid, lambda _, k, v: rows.append(k))
        ref = eager(lambda: dmod._prefill_layers(d1, cfg1, x, valid,
                                                 lambda _, k, v: erows.append(k)))
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        assert rel <= 1e-2, (l, rel)
        assert _bf16_moved(rows[0], erows[0]) <= PF_LAYER_K_MOVED, l
        x = ref

    fused0 = dmod._prefill_layers.fused_layers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hf = dmod._prefill_layers(dec, cfg, h, valid, lambda *a: None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dmod._prefill_layers.fused_layers == fused0 + cfg.n_layers
    he = eager(lambda: dmod._prefill_layers(dec, cfg, h, valid, lambda *a: None))
    tf = int(torch.argmax(dmod.lm_logits(dec, cfg, hf[0, P - 1])))
    te = int(torch.argmax(dmod.lm_logits(dec, cfg, he[0, P - 1])))
    assert tf == te


@pytest.mark.cuda
def test_cli_request_prefills_fused(cuda_kernels):
    """The CLI default (`Qwen3ASR(quantize="auto")`, the 0.6B config) runs
    its prefill as 28 fused layers and no eager one."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

    asr = Qwen3ASR(quantize="auto", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    pcm = (np.sin(np.arange(5 * 16000) / 16000 * 2 * np.pi * 440) * 8000).astype(np.int16)
    counts = dmod._prefill_layers.fused_layers, dmod._prefill_layers.eager_layers
    r = asr.transcribe(pcm, TranscribeParams(max_tokens=4, fused=True, print_timing=False))
    assert r.success
    assert (dmod._prefill_layers.fused_layers - counts[0],
            dmod._prefill_layers.eager_layers - counts[1]) == (28, 0)


# -- the MoE thinker's kernels (ops/moe.py, csrc/moe.cu) ---------------------------

def _moe_decoder(L: int = 2, E: int = 16, K: int = 4, V: int = 4096):
    """A Qwen3-MoE decoder at the thinker's widths (hidden 2,048, 32 / 4
    heads of 128, experts of 768) with E experts, top K, L layers, a V-entry
    vocabulary: int8pc attention and head, int8 experts, the MoE step's
    pack."""
    from qwen3_asr_tpu_torch.config import MoeDecoderConfig
    from qwen3_asr_tpu_torch.ops import moe

    cfg = MoeDecoderConfig(vocab_size=V, hidden_size=2048, n_layers=L, n_heads=32,
                           n_kv_heads=4, head_dim=128, intermediate_size=768, n_experts=E,
                           n_experts_per_tok=K, eos_token_id=-1)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dec = tparams.init_decoder_params(cfg, gen, torch.bfloat16, "cuda")
    dec = tparams.fuse_decoder_params(tparams.quantize_decoder_params(dec, "int8pc"))
    dec["moe"] = moe.pack_moe_params(dec, cfg)
    return cfg, dec


@pytest.mark.cuda
@pytest.mark.parametrize("N,skewed", [(37, False), (410, False), (200, True)])
def test_moe_prefill_products_match_twins(cuda_kernels, N, skewed):
    """The router's sort, the grouped gate-up products (the SwiGLU rows),
    their codes (F1) and the grouped down products equal their twins on the
    same inputs bit for bit (integer products are exact), the residual
    pass's rows too and its codes within one (the norm's sum order); skewed:
    most rows
    on two experts (tiles past 32 pairs), two experts with none."""
    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops import prefill_fused as pf
    from qwen3_asr_tpu_torch.ops.prefill_fused import codes_buffer

    cfg, dec = _moe_decoder()
    H, F, E, K = 2048, 768, 16, 4
    lay = dec["layers"]
    g = torch.Generator(device="cuda").manual_seed(N)
    codes = codes_buffer(N, H, "cuda")
    codes[:N] = torch.randint(-127, 128, (N, H), generator=g, device="cuda", dtype=torch.int8)
    router = lay["router"][0].clone()
    if skewed:
        codes[:N, :3] = 127
        codes[N * 4 // 5:N, :2] = -127
        router[:, :2] = 0
        router[0, 0] = router[1, 1] = 1.0
        router[:, E - 2:] = 0
        router[2, E - 2:] = -1.0
    sx = torch.rand(N, 1, generator=g, device="cuda") * 0.01 + 1e-3
    res = (torch.randn(N, H, generator=g, device="cuda") * 3).to(torch.bfloat16)
    gu = {k: v[0] for k, v in lay["experts_gu"].items()}
    dn = {k: v[0] for k, v in lay["experts_down"].items()}
    wts, order, off = moe.route(codes, sx, router, K)
    work = moe.prefill_work(N, H, F, K, "cuda")
    act = moe.moe_gate_up(codes, sx, order, off, gu["q"], gu["s"], K, work)
    pf.norm_quant_rows(act, None, cfg.rms_norm_eps, work["fq"], work["fs"])
    fq, fs = work["fq"], work["fs"]
    ys = moe.moe_down(fq, fs, order, off, wts, dn["q"], dn["s"], work)
    oc, osx = codes_buffer(N, H, "cuda"), torch.empty(N, 1, device="cuda")
    x = moe.moe_combine(res, ys, K, lay["attn_norm"][1], cfg.rms_norm_eps, oc, osx)
    c = (lambda t: t.cpu())
    rw, ro, rf = moe.route_ref(c(codes), c(sx), c(router), K)
    assert torch.equal(off.cpu(), rf)
    # the kernel's weights: exp(l - max) over the top k's sum, the twin's the
    # softmax renormalised: the same numbers within f32 rounding
    pairs = order.cpu().long()
    torch.testing.assert_close(wts.cpu(), rw, rtol=1e-5, atol=1e-7)
    assert torch.equal(torch.sort(pairs).values, torch.arange(N * K))
    cw = moe.prefill_work(N, H, F, K, "cpu")
    ract = moe.moe_gate_up_ref(c(codes), c(sx), c(order), c(off), c(gu["q"]), c(gu["s"]), K,
                               cw)
    assert torch.equal(act.cpu(), ract)
    pf.norm_quant_rows_ref(ract, None, cfg.rms_norm_eps, cw["fq"], cw["fs"])
    rq, rs = cw["fq"], cw["fs"]
    assert torch.equal(fq.cpu(), rq) and torch.equal(fs.cpu(), rs)
    rys = moe.moe_down_ref(rq, rs, c(order), c(off), c(wts), c(dn["q"]), c(dn["s"]), cw)
    assert torch.equal(ys.cpu(), rys)
    rc, rsx = codes_buffer(N, H, "cpu"), torch.empty(N, 1)
    rx = moe.moe_combine_ref(c(res), c(ys), K, c(lay["attn_norm"][1]), cfg.rms_norm_eps, rc,
                             rsx)
    assert torch.equal(x.cpu(), rx)
    assert int((oc[:N].cpu().int() - rc[:N].int()).abs().max()) <= 1
    counts = torch.diff(off).cpu()
    assert work["stats"].cpu().tolist() == [int((counts > 0).sum()), int(counts.max())]
    if skewed:
        assert counts[E - 2:].tolist() == [0, 0] and int(counts.max()) > 32


def _moe_cache(L: int, S: int, kv: str, g) -> list:
    """A random bf16 cache, or int8 with its scales, [L, S, 512] (the
    thinker's 4 KV heads of 128): [k, v, k_s, v_s], the scales None for
    bf16."""
    if kv == "bf16":
        return [(torch.randn(L, S, 512, generator=g, device="cuda") * 2).to(torch.bfloat16)
                for _ in range(2)] + [None, None]
    cache = [torch.randint(-100, 101, (L, S, 512), generator=g, device="cuda",
                           dtype=torch.int8) for _ in range(2)]
    return cache + [torch.rand(L, S, 4, generator=g, device="cuda") * 0.02 + 1e-3
                    for _ in range(2)]


def _moe_step_checks(cfg, pack, cache, pos: int, n_steps: int, g) -> None:
    """Each layer of the MoE step alone against the twin on the same input
    row and cache at pos (h within 1e-2), then n_steps graphed steps from
    pos bit-equal to as many eager ones, caches included."""
    import dataclasses

    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops.megakernel import GraphStep

    clone = (lambda ts: [t.clone() if t is not None else None for t in ts])
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    c1 = dataclasses.replace(cfg, n_layers=1)
    for l in range(cfg.n_layers):
        one = {k: (v[l:l + 1] if k not in ("head_q", "head_s", "out_norm", "embd") else v)
               for k, v in pack.items()}
        lc = [t[l:l + 1].clone() if t is not None else None for t in cache]
        x = (torch.randn(1, cfg.hidden_size, generator=g, device="cuda") * 3).to(torch.bfloat16)
        s1 = moe.MoeDecodeStep(one, c1, *clone(lc))
        s1(x, pos, out)
        _, rh = moe.moe_decode_step_ref(one, c1, x, pos, *clone(lc))
        assert float((s1.h - rh).norm() / rh.norm()) < 1e-2, l
    a, b = clone(cache), clone(cache)
    e = moe.MoeDecodeStep(pack, cfg, *a)
    o1 = torch.zeros(n_steps + 1, dtype=torch.int32, device="cuda")
    o1[0] = 77
    for i in range(1, n_steps + 1):
        e(o1[i - 1:i], pos + i - 1, o1[i:i + 1])
    gs = GraphStep(moe.MoeDecodeStep(pack, cfg, *b))
    o2 = torch.zeros(n_steps + 1, dtype=torch.int32, device="cuda")
    o2[0] = 77
    for i in range(1, n_steps + 1):
        gs(o2, i, pos + i - 1)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)
    assert all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_decode_step_matches_twin(cuda_kernels, kv):
    """The MoE step: 4 L + 4 kernels a step, its attention half on one block
    an SM; each layer alone against the twin on the same input and cache (h
    within 1e-2); 32 graphed steps bit-equal to 32 eager ones, caches
    included."""
    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

    cfg, dec = _moe_decoder()
    pack, L = dec["moe"], cfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(2)
    cache = _moe_cache(L, 512, kv, g)
    step = moe.MoeDecodeStep(pack, cfg, *[t.clone() if t is not None else None for t in cache])
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    tok = torch.tensor([123], dtype=torch.int32, device="cuda")
    step.pos.fill_(300)
    assert kernels_a_call(lambda: step(tok, step.pos, out)) == moe.step_kernels(L) == 4 * L + 4
    assert step.attn_blocks == torch.cuda.get_device_properties(0).multi_processor_count
    _moe_step_checks(cfg, pack, cache, 300, 32, g)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_attn_layer_loops_over_more_chunks_than_blocks(cuda_kernels, kv):
    """At a position whose attention chunks alone outnumber the persistent
    launch's blocks (each block then takes several tasks, and the merges
    fall to whichever finishes a head last): each layer within 1e-2 of the
    twin, 8 graphed steps bit-equal to 8 eager ones."""
    from qwen3_asr_tpu_torch.ops import moe

    cfg, dec = _moe_decoder()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    pos = 64 * blocks + 150
    S = pos + 64
    g = torch.Generator(device="cuda").manual_seed(3)
    cache = _moe_cache(cfg.n_layers, S, kv, g)
    step = moe.MoeDecodeStep(dec["moe"], cfg, *cache)
    assert -(-pos // 64) > step.attn_blocks
    _moe_step_checks(cfg, dec["moe"], cache, pos, 8, g)


@pytest.mark.cuda
def test_moe_prefill_waits_on_no_host(cuda_kernels):
    """The MoE prefill's layer stack (the router's sort, the grouped products,
    the fused passes) runs under set_sync_debug_mode("error"), counted as
    fused layers, its rows finite."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    cfg, dec = _moe_decoder()
    g = torch.Generator(device="cuda").manual_seed(4)
    h = (torch.randn(1, 160, cfg.hidden_size, generator=g, device="cuda") * 0.5).to(
        torch.bfloat16)
    valid = torch.tensor([150], dtype=torch.int32, device="cuda")
    dmod._prefill_layers(dec, cfg, h, valid, lambda *a: None)   # RoPE's table, once a device
    fused0 = dmod._prefill_layers.fused_layers
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dmod._prefill_layers(dec, cfg, h, valid, lambda *a: None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dmod._prefill_layers.fused_layers == fused0 + cfg.n_layers
    assert bool(torch.isfinite(out.float()).all())
