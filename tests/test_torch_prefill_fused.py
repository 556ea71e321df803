"""The int8pc prefill's fused chain (`models/decoder.py::_prefill_fused`,
`ops/prefill_fused.py`) on the CPU, where its passes take their plain twins:
at the 0.6B widths with 2 layers, each twin gives the eager chain's tensors
bit for bit, step by step through a layer, and the whole `_prefill_layers`
gives today's output and cache rows unchanged; `fused_layers` /
`eager_layers` count which chain ran for dense, Q8_0 and int8pc leaves.
The kernels themselves are held against the twins on the card
(tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.config import ASRModelConfig, tiny_asr_config
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.ops import prefill_fused as pf
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
from qwen3_asr_tpu_torch.ops.q8_matmul import (
    int8_matmul,
    matmul_any,
    padded_rows,
    quantize_rows,
)
from qwen3_asr_tpu_torch.runtime import params as tparams

SHAPES = [(B, T) for B in (1, 3) for T in (1, 7, 33, 300)]
IDS = [f"B{B}-T{T}" for B, T in SHAPES]


def _decoder(cfg, mode, dtype=torch.bfloat16, seed=0):
    dec = tparams.init_decoder_params(cfg, torch.Generator().manual_seed(seed), dtype, "cpu")
    if mode:
        dec = tparams.quantize_decoder_params(dec, mode, lm_head=False)
    return tparams.fuse_decoder_params(dec)


@pytest.fixture(scope="module")
def wide():
    """The 0.6B decoder's widths, 2 layers, int8pc leaves, bf16."""
    cfg = dataclasses.replace(ASRModelConfig().decoder, n_layers=2)
    return cfg, _decoder(cfg, "int8pc")


def _prompt(cfg, B, T, seed=1):
    g = torch.Generator().manual_seed(seed + 7 * T + B)
    h = (torch.randn(B, T, cfg.hidden_size, generator=g) * 0.5).to(torch.bfloat16)
    valid = torch.tensor([max(1, T - 3 * b) for b in range(B)], dtype=torch.int32)
    return h, valid


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(tdec, "_fusable", lambda *a: False)
        return fn()


@pytest.mark.parametrize("B,T", SHAPES, ids=IDS)
def test_twins_equal_the_eager_chain(wide, B, T):
    """Layer 0 pass by pass: each fused pass (its twin on the CPU) against
    the eager ops it stands for, on the same input."""
    cfg, dec = wide
    lay, eps = dec["layers"], cfg.rms_norm_eps
    NH, NKV, D, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.intermediate_size
    h, valid = _prompt(cfg, B, T)
    N, H = B * T, cfg.hidden_size
    x = h.reshape(N, H)
    w = {n: tdec._leaf(lay, n, 0) for n in tdec._PC_MATRICES}
    xq, aq, fq = (pf.codes_buffer(N, n, "cpu") for n in (H, NH * D, F))
    sx, asx, fsx = (torch.empty(N, 1) for _ in range(3))

    def same_codes(codes, s, y):
        want_q, want_s = quantize_rows(y.float())
        assert codes.shape[0] == padded_rows(N)
        assert torch.equal(codes[:N], want_q) and torch.equal(s, want_s)
        assert not codes[N:].any()

    pf.norm_quant_rows(x, lay["attn_norm"][0], eps, xq, sx)
    y = tdec.rms_norm(x, lay["attn_norm"][0], eps)
    same_codes(xq, sx, y)

    q, k, v = pf.qkv_epilogue(int8_matmul(xq, w["wqkv"]["i8pc:q"]), sx, w["wqkv"]["i8pc:s"],
                              lay["q_norm"][0], lay["k_norm"][0], T, NH, NKV, D, eps,
                              tdec.rope_inv_freq(D, cfg.rope_theta, torch.device("cpu")))
    qkv = matmul_any(y, w["wqkv"]).reshape(B, T, -1)
    pos = torch.arange(T, dtype=torch.int32)
    want_q = tdec.rope_neox(tdec.rms_norm(qkv[..., :NH * D].reshape(B, T, NH, D),
                                          lay["q_norm"][0], eps), pos, cfg.rope_theta)
    want_k = tdec.rope_neox(tdec.rms_norm(qkv[..., NH * D:(NH + NKV) * D].reshape(
        B, T, NKV, D), lay["k_norm"][0], eps), pos, cfg.rope_theta)
    want_v = qkv[..., (NH + NKV) * D:].reshape(B, T, NKV, D)
    for got, want in ((q, want_q), (k, want_k), (v, want_v)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)

    attn = flash_attention_batch(q, k, v, valid, causal=True,
                                 scale=1.0 / float(np.sqrt(D))).reshape(N, NH * D)
    pf.norm_quant_rows(attn, None, eps, aq, asx)
    same_codes(aq, asx, attn)

    h1 = pf.residual_norm_quant(x, int8_matmul(aq, w["wo"]["i8pc:q"]), asx, w["wo"]["i8pc:s"],
                                lay["ffn_norm"][0], eps, xq, sx)
    want_h1 = x + matmul_any(attn, w["wo"])
    assert torch.equal(h1, want_h1)
    y = tdec.rms_norm(want_h1, lay["ffn_norm"][0], eps)
    same_codes(xq, sx, y)

    pf.swiglu_quant(int8_matmul(xq, w["w_gate_up"]["i8pc:q"]), sx, w["w_gate_up"]["i8pc:s"],
                    F, fq, fsx)
    g_u = matmul_any(y, w["w_gate_up"])
    ffn = tdec.silu(g_u[:, :F]) * g_u[:, F:]
    same_codes(fq, fsx, ffn)

    out = pf.residual_norm_quant(h1, int8_matmul(fq, w["w_down"]["i8pc:q"]), fsx,
                                 w["w_down"]["i8pc:s"], lay["attn_norm"][1], eps, xq, sx)
    want_out = want_h1 + matmul_any(ffn, w["w_down"])
    assert torch.equal(out, want_out)
    same_codes(xq, sx, tdec.rms_norm(want_out, lay["attn_norm"][1], eps))
    # the last layer's pass writes the residual alone
    before = xq.clone(), sx.clone()
    last = pf.residual_norm_quant(h1, int8_matmul(fq, w["w_down"]["i8pc:q"]), fsx,
                                  w["w_down"]["i8pc:s"], None, eps, xq, sx)
    assert torch.equal(last, want_out)
    assert torch.equal(xq, before[0]) and torch.equal(sx, before[1])


@pytest.mark.parametrize("B,T", SHAPES, ids=IDS)
def test_prefill_layers_unchanged_on_cpu(wide, monkeypatch, B, T):
    """The fused chain's hidden states and on_rows rows equal the eager
    chain's bit for bit; one count of n_layers on each chain's counter."""
    cfg, dec = wide
    h, valid = _prompt(cfg, B, T)
    rows, eager_rows = [], []
    fused0, eager0 = tdec._prefill_layers.fused_layers, tdec._prefill_layers.eager_layers
    got = tdec._prefill_layers(dec, cfg, h, valid, lambda l, k, v: rows.append((l, k, v)))
    assert tdec._prefill_layers.fused_layers == fused0 + cfg.n_layers
    assert tdec._prefill_layers.eager_layers == eager0
    want = _eager(monkeypatch, lambda: tdec._prefill_layers(
        dec, cfg, h, valid, lambda l, k, v: eager_rows.append((l, k, v))))
    assert tdec._prefill_layers.eager_layers == eager0 + cfg.n_layers
    assert got.shape == (B, T, cfg.hidden_size) and torch.equal(got, want)
    assert [r[0] for r in rows] == list(range(cfg.n_layers))
    for (_, k, v), (_, k2, v2) in zip(rows, eager_rows, strict=True):
        assert torch.equal(k, k2) and torch.equal(v, v2)


@pytest.mark.parametrize("kv", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_cache_and_batch_prefill_unchanged(wide, monkeypatch, kv):
    """decoder_forward's prefill (the caches it fills) and
    decoder_prefill_batch (its rows) are the eager chain's on int8pc."""
    cfg, dec = wide
    h, valid = _prompt(cfg, 1, 40)

    def run():
        cache = tdec.init_kv_cache(cfg, 64, "cpu", kv)
        out = tdec.decoder_forward(dec, cfg, h[0], cache, 37)
        hb, rows = tdec.decoder_prefill_batch(dec, cfg, torch.cat([h, h.flip(1)]),
                                              torch.tensor([37, 40], dtype=torch.int32))
        return out, cache, hb, rows

    got, want = run(), _eager(monkeypatch, run)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    for a, b in ((got[1], want[1]), (got[3], want[3])):
        assert a.keys() == b.keys() and all(torch.equal(a[n], b[n]) for n in a)


@pytest.mark.parametrize("mode,dtype,fused", [
    (None, torch.bfloat16, False), ("q8_0", torch.bfloat16, False),
    ("int8pc", torch.bfloat16, True), ("int8pc", torch.float32, False)],
    ids=["dense", "q8_0", "int8pc", "int8pc-f32"])
def test_layer_counters(mode, dtype, fused):
    """Dense and Q8_0 leaves, and int8pc leaves under f32 rows, keep the
    eager chain; bf16 rows on int8pc leaves take the fused one. A prefill
    counts its layers once, on one counter."""
    cfg = tiny_asr_config().decoder
    dec = _decoder(cfg, mode, dtype, seed=3)
    h = torch.randn(2, 9, cfg.hidden_size, generator=torch.Generator().manual_seed(4)
                    ).to(dtype)
    fused0, eager0 = tdec._prefill_layers.fused_layers, tdec._prefill_layers.eager_layers
    out = tdec._prefill_layers(dec, cfg, h, torch.tensor([9, 5], dtype=torch.int32),
                               lambda l, k, v: None)
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    n = cfg.n_layers
    assert tdec._prefill_layers.fused_layers == fused0 + (n if fused else 0)
    assert tdec._prefill_layers.eager_layers == eager0 + (0 if fused else n)


@pytest.mark.parametrize("N", [1, 16, 17, 33, 300])
def test_codes_buffer_takes_int_mm_rows(N):
    """A codes buffer has the row count torch._int_mm takes (more than 16, a
    multiple of 8), zeroed, and int8_matmul of it gives N exact rows and
    zero rows past them."""
    buf = pf.codes_buffer(N, 64, "cpu")
    assert buf.shape == (padded_rows(N), 64) and buf.dtype == torch.int8
    assert buf.shape[0] > 16 and buf.shape[0] % 8 == 0 and buf.shape[0] >= N
    assert not buf.any()
    g = torch.Generator().manual_seed(N)
    buf[:N] = torch.randint(-127, 128, (N, 64), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 24), generator=g, dtype=torch.int8)
    acc = int8_matmul(buf, w)
    assert torch.equal(acc[:N], (buf[:N].long() @ w.long()).int())
    assert not acc[N:].any()


def test_rope_frequencies_copied_once():
    """rope_neox reads the frequencies from one tensor a (head_dim, theta,
    device), the reference's float64 formula rounded to f32, so no call
    after the first copies from the host."""
    d, theta = 128, 1e6
    first = tdec.rope_inv_freq(d, theta, torch.device("cpu"))
    assert tdec.rope_inv_freq(d, theta, torch.device("cpu")) is first
    want = (1.0 / (theta ** (np.arange(0, d // 2, dtype=np.float64) * 2.0 / d))
            ).astype(np.float32)
    np.testing.assert_array_equal(first.numpy(), want)
    pos = torch.arange(5, dtype=torch.int32)
    cos, sin = tdec.rope_tables(pos, first)
    ang = pos.float()[:, None] * torch.from_numpy(want)[None, :]
    assert torch.equal(cos, torch.cos(ang)[:, None, :])
    assert torch.equal(sin, torch.sin(ang)[:, None, :])
    hits = tdec.rope_inv_freq.cache_info().hits
    tdec.rope_neox(torch.ones(5, 2, d, dtype=torch.bfloat16), pos, theta)
    assert tdec.rope_inv_freq.cache_info().hits == hits + 1
