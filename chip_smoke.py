"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `qwen3_asr_tpu_torch/csrc` (into
`build/torch_kernels/`) and holds each kernel against its plain PyTorch
twin at the shapes of the main paths: flash attention (K2) single and
batched, the decode step (K1), and the batched decode step (K3), which must
equal K1 run on each row's slab bit for bit. Then, at the full
Qwen3-ASR-0.6B width with seeded random weights (int4 decode weights, int8
KV cache, EOS disabled), it drives three paths, each with the launch counts
set to 0 just before it and read just after:

1. `Qwen3ASR.transcribe` on three int16 requests of 5 s, 30 s and 92 s;
2. the continuous-batching engine on 8 requests admitted in two groups of
   4 (the second mid-flight), whose tokens must equal `transcribe_batch`'s
   on the same groups (that closed-batch reference is a window of its own,
   its counts reset before it and checked after it);
3. `ASRServer` in continuous mode behind the HTTP front end: 4 concurrent
   `/v1/transcribe` requests, one SSE `/v1/audio/transcriptions` request
   and `/healthz`.

It checks that every parameter and cache tensor of path 1 is on the GPU,
that each kernel of a path ran there (launch counts), and that tokens agree
with the twins' on a 5 s request of paths 1 and 2.

Output: diagnostic lines, then one JSON line with the kernels' errors and
times, then, as the last line, {"ok": true, "device": {...}}. Exits non-zero
without the last line if there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

NEAR_TIE_TOL = 0.2      # argmax flips below this logit gap (scripts/chipgate.py)
# Flash kernel vs twin: both round f32 math to bf16 once, so they differ by
# at most one bf16 ulp (< 2**-7 of |ref|) where the f32 sums straddle a
# rounding boundary: |err| <= FLASH_ATOL + FLASH_RTOL * |ref| elementwise.
FLASH_RTOL, FLASH_ATOL = 1e-2, 1e-3
# Megakernel vs twin, teacher-forced over 28 layers. Both quantize every
# activation to int8: where one f32 sum rounds a bf16 attention output one
# ulp the other way, an int8 code moves and the next layers spread it, so h
# (the hidden state after 28 layers) is bit-exact on most steps and off by
# up to ~0.17 relative L2 on the others (the twin on the CPU vs the twin on
# the GPU: up to ~0.07). Held: h rel L2 <= MEGA_H_REL on every step and
# bit-exact on at least half of them; the fresh cache rows of every layer on
# a bit-exact step, and of layer 0 on the others (the later layers' inputs
# differ), agree with the twin's: int8 codes within one on <= CACHE_CODE_FRAC
# of entries, scales at rtol CACHE_SCALE_RTOL. A fault that moves every
# step's h a little leaves no step bit-exact.
MEGA_H_REL = 0.25
CACHE_CODE_FRAC, CACHE_SCALE_RTOL = 0.01, 1e-2
# One layer alone on the same input (both get the twin's input to that
# layer): its fresh cache rows agree as above and h rel L2 <= MEGA_LAYER_REL.
# h is bit-exact unless an attention output rounds the other way (~4e-3).
MEGA_LAYER_REL = 1e-2
FLOOR_STEPS = 3         # steps on which the twin also runs on the CPU
REQUESTS = ((5, 64), (30, 128), (92, 323))   # (seconds, max_tokens)
MEGA_BATCH_S, MEGA_BATCH_STEPS = 1664, 16   # K3 phase: pool context, steps vs K1


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over n runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def pcm(seconds: float, seed: int = 0):
    """The bench's synthetic audio: a 440 Hz tone plus noise, int16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    return (a * 32768.0).clip(-32768, 32767).astype(np.int16)


def phase_flash(causal: bool, T: int, NH: int, NKV: int, D: int, valid):
    """K2 vs its plain version on a batch of len(valid) items (keys at
    index >= valid[b] masked)."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.ops import flash_attention as fa

    B = len(valid)
    g = torch.Generator(device="cuda").manual_seed(T + B)
    q = torch.randn(B, T, NH, D, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, T, NKV, D, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, T, NKV, D, generator=g, device="cuda").to(torch.bfloat16)
    vl = torch.tensor(valid, dtype=torch.int32, device="cuda")
    scale = 1.0 / float(np.sqrt(D))
    out = fa.flash_attention_batch(q, k, v, vl, causal=causal, scale=scale)
    ref = fa.flash_attention_ref(q, k, v, vl, causal=causal, scale=scale)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    ratio = float((diff / (FLASH_ATOL + FLASH_RTOL * ref.float().abs())).max())
    ms = cuda_ms(lambda: fa.flash_attention_batch(q, k, v, vl, causal=causal,
                                                  scale=scale), 20)
    plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, vl, causal=causal,
                                                   scale=scale), 5)
    name = "causal" if causal else "bidirectional"
    log(f"phase flash {name} B={B} T={T} NH={NH} NKV={NKV} D={D} valid={valid}: "
        f"max_abs_err={err:.3e} worst |err| / (atol + rtol |ref|) "
        f"{ratio:.4f}; kernel {ms:.4f} ms, twin {plain:.4f} ms")
    if not ratio <= 1.0:
        raise AssertionError(f"flash {name}: |err| exceeds {FLASH_ATOL} + "
                             f"{FLASH_RTOL} |ref| ({ratio:.3f}x)")
    return err, ms, plain


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _bad_cache_layers(got, want, pos: int) -> list[int]:
    """Layers whose fresh row `pos` (k, v and their scales) breaks the
    cache rule against the twin's. got/want: (k, v, k_s, v_s) [L, S, ...]."""
    import torch

    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    for a, b in zip(got[:2], want[:2]):
        d = (a[:, pos].int() - b[:, pos].int()).abs()
        bad |= (d.amax(dim=1) > 1) | ((d > 0).float().mean(dim=1) > CACHE_CODE_FRAC)
    for a, b in zip(got[2:], want[2:]):
        rel = (a[:, pos] - b[:, pos]).abs() / b[:, pos].abs()
        bad |= rel.amax(dim=1) > CACHE_SCALE_RTOL
    return torch.nonzero(bad).flatten().tolist()


def _filled_cache(dcfg, S: int, n: int, g):
    """(k, v, k_s, v_s) [L, S, ...] with rows < n quantized from N(0, 0.25)."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows

    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    out = []
    for _ in range(2):
        q, s = _quantize_kv_rows(
            torch.randn(L * n, NKV, D, generator=g, device="cuda") * 0.5)
        c = torch.zeros(L, S, NKV * D, dtype=torch.int8, device="cuda")
        sc = torch.zeros(L, S, NKV, dtype=torch.float32, device="cuda")
        c[:, :n] = q.reshape(L, n, NKV * D)
        sc[:, :n] = s.reshape(L, n, NKV)
        out += [c, sc]
    return out[0], out[2], out[1], out[3]


def phase_mega(cfg, dec):
    """Kernel vs twin, teacher-forced: 32 steps from a prefilled cache,
    where at every step both get the same token and the same cache (the
    twin's copy takes the kernel's fresh rows after each step, once they
    have been compared). Then every layer alone on the same input."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk

    dcfg = cfg.decoder
    pack = dec["mega"]
    S, pos0, steps = 1664, 1216, 32
    got = _filled_cache(dcfg, S, pos0, torch.Generator(device="cuda").manual_seed(1))
    ref = [t.clone() for t in got]
    step = mk.DecodeStep(pack, dcfg, *got)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    tok = torch.tensor([1000], dtype=torch.int32, device="cuda")
    cpu_pack = {k: v.cpu() for k, v in pack.items()}
    max_err, rels, floors, mism, worst_gap = 0.0, [], [], 0, 0.0
    for i in range(steps):
        pos = pos0 + i
        if i < FLOOR_STEPS:  # the twin on the CPU, on the same inputs
            cpu_cache = [t[:, :pos + 1].cpu() for t in ref]
            cpu_h = mk.mega_decode_step_i8_ref(cpu_pack, dcfg, tok.cpu(), pos,
                                               *cpu_cache)[1]
        step(tok, pos, out)
        rt, rh, logits = mk.mega_decode_step_i8_ref(
            pack, dcfg, tok, pos, *ref, return_logits=True)
        torch.cuda.synchronize()
        max_err = max(max_err, float((step.h - rh).abs().max()))
        rels.append(_rel(step.h, rh))
        if i < FLOOR_STEPS:
            floors.append(_rel(cpu_h, rh.cpu()))
        got_t, want_t = int(out[0]), int(rt[0])
        if got_t != want_t:
            mism += 1
            worst_gap = max(worst_gap, float(logits[want_t] - logits[got_t]))
        bad = _bad_cache_layers(got, ref, pos)
        if bad and (rels[-1] == 0.0 or bad[0] == 0):
            raise AssertionError(f"mega step {i} (h rel L2 {rels[-1]:.4f}): "
                                 f"fresh cache rows of layers {bad} differ")
        for a, b in zip(got, ref):
            b[:, pos] = a[:, pos]
        tok = rt.clone()
    n_exact = sum(r == 0.0 for r in rels)
    layer_rels = phase_mega_layers(dcfg, pack, got, ref, pos0 + steps, tok)
    ms = cuda_ms(lambda: step(tok, pos0 + steps, out), 50)
    plain = cuda_ms(lambda: mk.mega_decode_step_i8_ref(
        pack, dcfg, tok, pos0 + steps, *ref), 3, warmup=1)
    log(f"phase megakernel S={S} pos={pos0}..{pos0 + steps - 1}: "
        f"max_abs_err(h)={max_err:.3e} rel_l2(h) max {max(rels):.4f}, "
        f"bit-exact on {n_exact}/{steps} steps; twin cpu vs twin cuda "
        f"rel_l2(h) {', '.join(f'{f:.4f}' for f in floors)}; token "
        f"mismatches={mism}/{steps} (worst twin logit gap {worst_gap:.4f}); "
        f"kernel {ms:.4f} ms/step, twin {plain:.4f} ms/step")
    log("  rel_l2(h) per step: " + " ".join(f"{r:.4f}" for r in rels))
    log(f"  one layer on the same input, pos={pos0 + steps}: rel_l2(h) max "
        f"{max(layer_rels):.3e}, per layer: "
        + " ".join(f"{r:.1e}" for r in layer_rels))
    if worst_gap > NEAR_TIE_TOL:
        raise AssertionError("megakernel tokens disagree with the twin")
    if not max(rels) <= MEGA_H_REL:
        raise AssertionError(f"megakernel h rel_l2 {max(rels)} > {MEGA_H_REL}")
    if 2 * n_exact < steps:
        raise AssertionError(f"megakernel h bit-exact on {n_exact}/{steps} steps")
    if not max(layer_rels) <= MEGA_LAYER_REL:
        raise AssertionError(f"one-layer h rel_l2 {max(layer_rels)} > "
                             f"{MEGA_LAYER_REL}")
    return max_err, ms, plain


LAYER_LEAVES = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q",
                "wd_s", "attn_norm", "ffn_norm", "q_norm", "k_norm")


def phase_mega_layers(dcfg, pack, got, ref, pos: int, tok) -> list[float]:
    """Each layer alone (the kernel on a one-layer slice of the pack and
    the cache, bf16 row input) on the twin's input to that layer: its fresh
    cache rows must agree with the twin's. -> h rel L2 per layer."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cfg1 = dataclasses.replace(dcfg, n_layers=1)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    x = pack["embd"][tok.long()].reshape(1, -1).contiguous()
    rels = []
    for l in range(dcfg.n_layers):
        pk = {n: (t[l:l + 1] if n in LAYER_LEAVES else t) for n, t in pack.items()}
        g1, r1 = [t[l:l + 1] for t in got], [t[l:l + 1] for t in ref]
        step = mk.DecodeStep(pk, cfg1, *g1)
        step(x, pos, out)
        rh = mk.mega_decode_step_i8_ref(pk, cfg1, x, pos, *r1)[1]
        torch.cuda.synchronize()
        if _bad_cache_layers(g1, r1, pos):
            raise AssertionError(f"layer {l} on the same input: fresh cache "
                                 f"rows differ")
        rels.append(_rel(step.h, rh))
        x = rh.to(torch.bfloat16).contiguous()
    return rels


def _filled_pool(dcfg, S: int, pos, seed: int):
    """(k, v, k_s, v_s) [B, L, S, ...]: slab b's rows < pos[b] filled as
    _filled_cache fills them."""
    import torch

    slabs = [_filled_cache(dcfg, S, int(p),
                           torch.Generator(device="cuda").manual_seed(seed + b))
             for b, p in enumerate(pos)]
    return [torch.stack([s[i] for s in slabs]) for i in range(4)]


def _spread(B: int):
    """B cache positions spread over 64 .. 1600."""
    import numpy as np

    return [int(p) for p in np.linspace(64, 1600, B).round()]


def phase_mega_batch(dcfg, pack):
    """K3 at full width, S = MEGA_BATCH_S, B = 8 rows at spread positions.
    (a) 16 teacher-forced steps against K1 run on each row's slab copy:
    tokens, h and every layer's fresh K/V rows and scales torch.equal on
    every step and row. (b) 4 steps against the plain version under the
    megakernel phase's rules (near-tie tokens, h rel L2 <= MEGA_H_REL on
    every row-step and bit-exact on at least half, the cache rule).
    (c) ms/step at B = 1, 4, 8, 16 beside K1's, and the plain version's at
    B = 8."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb

    S, B = MEGA_BATCH_S, 8
    pos0 = _spread(B)
    pool = _filled_pool(dcfg, S, pos0, 100)
    singles = [[t[b].clone() for t in pool] for b in range(B)]
    step = mb.BatchDecodeStep(pack, dcfg, *pool)
    k1 = [mk.DecodeStep(pack, dcfg, *singles[b]) for b in range(B)]
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    toks = torch.arange(1000, 1000 + B, dtype=torch.int32, device="cuda")
    n_equal = 0
    for i in range(MEGA_BATCH_STEPS):
        pos = [p + i for p in pos0]
        step(toks, torch.tensor(pos, dtype=torch.int32, device="cuda"), out,
             (min(pos), max(pos)))
        for b in range(B):
            k1[b](toks[b:b + 1], pos[b], one)
            same = (torch.equal(out[b:b + 1], one) and torch.equal(step.h[b:b + 1], k1[b].h)
                    and all(torch.equal(t[b, :, pos[b]], s[:, pos[b]])
                            for t, s in zip(pool, singles[b])))
            if not same:
                raise AssertionError(f"K3 row {b} differs from K1 on its slab at "
                                     f"step {i} (pos {pos[b]})")
            n_equal += 1
        toks = out.clone()
    # no stray writes: every row of every slab, not only the fresh ones
    for b in range(B):
        for i, (t, s) in enumerate(zip(pool, singles[b])):
            if not torch.equal(t[b], s):
                raise AssertionError(f"K3 cache pool tensor {i}, slab {b} differs "
                                     f"from K1's slab after {MEGA_BATCH_STEPS} steps")
    log(f"phase K3 vs K1 S={S} B={B} pos={pos0[0]}..{pos0[-1]}: "
        f"{n_equal}/{MEGA_BATCH_STEPS * B} row-steps torch.equal (token, h, "
        f"fresh K/V rows and scales of all {dcfg.n_layers} layers); whole "
        f"cache pool torch.equal to the K1 slabs after the last step")

    # (b) against the plain version, teacher-forced on its tokens
    ref = [t.clone() for t in pool]
    base = MEGA_BATCH_STEPS
    rels, mism, worst_gap, max_err = [], 0, 0.0, 0.0
    for i in range(4):
        pos = [p + base + i for p in pos0]
        step(toks, torch.tensor(pos, dtype=torch.int32, device="cuda"), out,
             (min(pos), max(pos)))
        nxt = []
        for b in range(B):
            rb = [t[b] for t in ref]
            rt, rh, logits = mk.mega_decode_step_i8_ref(
                pack, dcfg, toks[b:b + 1], pos[b], *rb, return_logits=True)
            torch.cuda.synchronize()
            max_err = max(max_err, float((step.h[b] - rh[0]).abs().max()))
            rels.append(_rel(step.h[b:b + 1], rh))
            got_t, want_t = int(out[b]), int(rt[0])
            if got_t != want_t:
                mism += 1
                worst_gap = max(worst_gap, float(logits[want_t] - logits[got_t]))
            bad = _bad_cache_layers([t[b] for t in pool], rb, pos[b])
            if bad and (rels[-1] == 0.0 or bad[0] == 0):
                raise AssertionError(f"K3 vs plain, step {i} row {b}: fresh cache "
                                     f"rows of layers {bad} differ")
            for a, r in zip(pool, ref):
                r[b, :, pos[b]] = a[b, :, pos[b]]
            nxt.append(rt)
        toks = torch.cat(nxt)
    n_exact = sum(r == 0.0 for r in rels)
    log(f"phase K3 vs plain, 4 steps x {B} rows: max_abs_err(h)={max_err:.3e} "
        f"rel_l2(h) max {max(rels):.4f}, bit-exact on {n_exact}/{len(rels)}; "
        f"token mismatches {mism} (worst plain logit gap {worst_gap:.4f})")
    if worst_gap > NEAR_TIE_TOL:
        raise AssertionError("K3 tokens disagree with the plain version")
    if not max(rels) <= MEGA_H_REL or 2 * n_exact < len(rels):
        raise AssertionError(f"K3 h vs plain: rel_l2 max {max(rels)}, "
                             f"{n_exact}/{len(rels)} bit-exact")

    # (c) times at the spread positions
    times = {}
    pos_end = max(pos) + 1
    for nb in (1, 4, 8, 16):
        p_b = _spread(nb) if nb > 1 else [pos0[B // 2]]
        pl = _filled_pool(dcfg, S, p_b, 200) if nb != B else pool
        st = mb.BatchDecodeStep(pack, dcfg, *pl)
        o = torch.empty(nb, dtype=torch.int32, device="cuda")
        tk = torch.full((nb,), 1000, dtype=torch.int32, device="cuda")
        pd = torch.tensor([min(p, pos_end) for p in p_b], dtype=torch.int32,
                          device="cuda")
        bounds = (int(pd.min()), int(pd.max()))
        times[nb] = cuda_ms(lambda: st(tk, pd, o, bounds), 20)
        del pl, st
    single = cuda_ms(lambda: k1[B // 2](toks[:1], pos0[B // 2] + base + 4, one), 20)
    plain = cuda_ms(lambda: mb.mega_decode_step_batch_ref(
        pack, dcfg, toks, [p + base + 4 for p in pos0], *ref), 1, warmup=1)
    log(f"phase K3 times (ms/step): " + ", ".join(
        f"B={nb} {t:.4f}" for nb, t in times.items())
        + f"; K1 {single:.4f} (B x K1 at B=8: {8 * single:.4f}); "
        f"plain at B=8 {plain:.4f}")
    return max_err, times[8], plain, times, single


def check_tokens_vs_twins(asr, samples, tokens, mel_bucket: int = 0):
    """The kernel path's tokens on one request vs the twins, teacher-forced
    on those tokens: each is the twin's argmax or within NEAR_TIE_TOL.
    mel_bucket > 0: the frontend is the bucketed batched one (the serving
    path), with the flash kernel's plain version in its encoder too."""
    import numpy as np
    import torch

    from qwen3_asr_tpu.text.prompt import audio_start_pos, build_asr_prompt
    from qwen3_asr_tpu_torch.audio.mel import mel_device
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models import encoder as emod
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.pipeline.asr import frontend_feats_batch

    cfg, dcfg, dec = asr.cfg, asr.cfg.decoder, asr.params["decoder"]
    kernel_flash = dmod.flash_attention_batch
    dmod.flash_attention_batch = emod.flash_attention_batch = fa.flash_attention_ref
    try:
        if mel_bucket:
            feats, n_audio = frontend_feats_batch(asr, [samples], mel_bucket)[0]
        else:
            buf, n_frames = _pad_pcm(samples)
            mel = mel_device(torch.from_numpy(buf).cuda(), asr.filters_t, n_frames).T
            feats = emod.encode(asr.params["encoder"], cfg.encoder, mel, n_frames)
            n_audio = feats.shape[0]
        prompt = build_asr_prompt(n_audio, dcfg)
        off, P = audio_start_pos(prompt, dcfg), len(prompt)
        S = -(-(P + len(tokens)) // 128) * 128
        cache = dmod.init_kv_cache(dcfg, S, "cuda")
        h0 = dmod.embed_with_audio(dec, torch.tensor(prompt, device="cuda"), feats,
                                   n_audio, off)
        h = dmod.decoder_forward(dec, dcfg, h0, cache, P)
    finally:
        dmod.flash_attention_batch = emod.flash_attention_batch = kernel_flash
    logits = [dmod.lm_logits(dec, dcfg, h[P - 1])]
    L, DKV = dcfg.n_layers, dcfg.n_kv_heads * dcfg.head_dim
    k3, v3 = cache["k"].view(L, S, DKV), cache["v"].view(L, S, DKV)
    for i in range(1, len(tokens)):
        t = torch.tensor([tokens[i - 1]], dtype=torch.int32, device="cuda")
        logits.append(mk.mega_decode_step_i8_ref(
            dec["mega"], dcfg, t, P + i - 1, k3, v3, cache["k_s"],
            cache["v_s"], return_logits=True)[2])
    gaps = []
    for lg, tok in zip(logits, tokens):
        best = int(torch.argmax(lg))
        gaps.append(float(lg[best] - lg[tok]))
    agree = sum(g == 0.0 for g in gaps)
    log(f"main path vs twins ({len(samples) / 16000:.0f} s request, "
        f"{len(tokens)} tokens): {agree} argmax-equal, worst gap "
        f"{max(gaps):.4f}")
    if max(gaps) > NEAR_TIE_TOL or not np.isfinite(gaps).all():
        raise AssertionError("main-path tokens disagree with the twins")


ENGINE_REQUESTS = (5, 10, 15, 30, 30, 60, 92, 92)   # seconds; two groups of 4
ENGINE_KW = dict(pool=8, round_tokens=64, mel_bucket=500)
ENGINE_S, ENGINE_TOKENS = 1536, 128


def counts() -> dict:
    """Launch counts of the three kernels' wrappers."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb

    return {"flash": fa.flash_attention_batch.launches,
            "mega": mk.mega_decode_step_i8.launches,
            "mega_batch": mb.mega_decode_step_batch.launches}


def reset_counts() -> None:
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb

    fa.flash_attention_batch.launches = 0
    mk.mega_decode_step_i8.launches = 0
    mb.mega_decode_step_batch.launches = 0


def encoder_calls(groups) -> int:
    """Batched encoder calls of the bucketed frontend (one per distinct
    mel bucket of each admitted or transcribed group)."""
    from qwen3_asr_tpu_torch.audio.mel import num_mel_frames

    b = ENGINE_KW["mel_bucket"]
    return sum(len({-(-num_mel_frames(len(x)) // b) for x in g}) for g in groups)


def check_launches(what: str, got: dict, k3_steps: int, groups) -> None:
    """K3 = k3_steps; K2 = 28 per batched prefill (one per group) + 18 per
    batched encoder call; no K1 on these paths."""
    from qwen3_asr_tpu.config import ASRModelConfig

    cfg = ASRModelConfig()
    want = {"flash": cfg.decoder.n_layers * len(groups)
            + cfg.encoder.n_layers * encoder_calls(groups),
            "mega": 0, "mega_batch": k3_steps}
    log(f"launches on the {what}: {got} (want {want})")
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")


def check_request(what: str, tokens, V: int) -> None:
    if len(tokens) != ENGINE_TOKENS or not all(0 <= t < V for t in tokens):
        raise AssertionError(f"{what}: {len(tokens)} tokens or one out of range")


def phase_engine(asr):
    """The continuous engine driven directly, so its admissions are fixed:
    the first 4 requests, one round, the other 4 (admitted mid-flight),
    then rounds until all are done. Every request ends with ENGINE_TOKENS
    in-range tokens equal to transcribe_batch's on the same group of 4;
    one request's tokens hold against the plain versions. Launch counts
    are checked over two windows, each reset just before it: the engine's
    run (rounds x round_tokens K3 steps) and the closed-batch reference
    (max_tokens - 1 steps per group). -> (pool tokens/s, the two windows'
    summed counts)."""
    import torch

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.pipeline.engine import ContinuousEngine

    audio = [pcm(sec, i) for i, sec in enumerate(ENGINE_REQUESTS)]
    groups = [audio[:4], audio[4:]]
    eng = ContinuousEngine(asr, max_tokens=ENGINE_TOKENS, s_pool=ENGINE_S, **ENGINE_KW)
    torch.cuda.synchronize()
    reset_counts()
    done, round_s = {}, []
    t0 = time.perf_counter()
    eng.admit(list(range(4)), groups[0])
    for i in range(64):
        if i == 1:
            eng.admit(list(range(4, 8)), groups[1])
        t1 = time.perf_counter()
        done.update(eng.run_round())
        round_s.append(time.perf_counter() - t1)
        if not eng.n_active():
            break
    wall = time.perf_counter() - t0
    engine_launches = counts()
    check_launches("engine path", engine_launches,
                   eng.n_rounds * ENGINE_KW["round_tokens"], groups)
    V = asr.cfg.decoder.vocab_size
    decode_tokens = sum(len(r.tokens) - 1 for r in done.values())
    log(f"phase engine: {len(done)} requests ({', '.join(map(str, ENGINE_REQUESTS))} s), "
        f"pool {eng.pool}, S={eng.S}, {eng.n_rounds} rounds of {eng.round_tokens}; "
        f"wall {wall * 1e3:.1f} ms, rounds {sum(round_s) * 1e3:.1f} ms; pool decode "
        f"{decode_tokens / sum(round_s):.1f} tokens/s ({decode_tokens} tokens); "
        f"stats {eng.stats()}")
    log("  request wall ms (admission to completion): " + ", ".join(
        f"{ENGINE_REQUESTS[k]} s {done[k].t_total_ms:.1f}" for k in sorted(done)))
    if sorted(done) != list(range(8)):
        raise AssertionError(f"engine completed {sorted(done)}")
    params = TranscribeParams(max_tokens=ENGINE_TOKENS, mel_bucket=ENGINE_KW["mel_bucket"])
    torch.cuda.synchronize()
    reset_counts()
    refs = [asr.transcribe_batch(group, params) for group in groups]
    closed_launches = counts()
    check_launches("closed-batch path", closed_launches,
                   len(groups) * (ENGINE_TOKENS - 1), groups)
    for g, ref in enumerate(refs):
        for j, r in enumerate(ref):
            k = 4 * g + j
            check_request(f"engine request {k}", done[k].tokens, V)
            if done[k].tokens != r.tokens:
                raise AssertionError(f"engine request {k} ({ENGINE_REQUESTS[k]} s) "
                                     f"differs from transcribe_batch")
    log("  engine tokens equal transcribe_batch's on both groups of 4")
    check_tokens_vs_twins(asr, audio[0], done[0].tokens[:16],
                          mel_bucket=ENGINE_KW["mel_bucket"])
    return decode_tokens / sum(round_s), {
        k: engine_launches[k] + closed_launches[k] for k in engine_launches}


def wav_bytes(samples) -> bytes:
    import io
    import struct

    import numpy as np

    pcm16 = np.asarray(samples, "<i2")
    buf = io.BytesIO()
    buf.write(b"RIFF" + struct.pack("<I", 36 + pcm16.nbytes) + b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2, 16))
    buf.write(b"data" + struct.pack("<I", pcm16.nbytes) + pcm16.tobytes())
    return buf.getvalue()


def phase_http(asr):
    """ASRServer (continuous pool) behind serve_http on 127.0.0.1, port 0:
    4 WAVs posted at once to /v1/transcribe, one SSE request to
    /v1/audio/transcriptions, then /healthz."""
    import json
    import threading
    import urllib.request

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.serve import ASRServer, serve_http

    server = ASRServer(asr, TranscribeParams(max_tokens=ENGINE_TOKENS,
                                             mel_bucket=ENGINE_KW["mel_bucket"]),
                       continuous=True, pool=ENGINE_KW["pool"],
                       round_tokens=ENGINE_KW["round_tokens"], engine_context=ENGINE_S)
    eng, groups = server._engine, []
    admit = eng.admit

    def recording_admit(tickets, samples):
        groups.append(list(samples))
        return admit(tickets, samples)

    eng.admit = recording_admit
    httpd = serve_http(server, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body, ctype="audio/wav"):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()

    try:
        reset_counts()
        t0 = time.perf_counter()
        replies = [None] * 4

        def one(i, sec):
            t1 = time.perf_counter()
            replies[i] = post("/v1/transcribe", wav_bytes(pcm(sec, 10 + i)))
            replies[i] += ((time.perf_counter() - t1) * 1e3,)

        threads = [threading.Thread(target=one, args=(i, sec))
                   for i, sec in enumerate((5, 15, 30, 92))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        boundary = "chipsmokeboundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"a.wav\"\r\n\r\n").encode() + wav_bytes(pcm(15, 20)) + (
            f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"stream\""
            f"\r\n\r\ntrue\r\n--{boundary}--\r\n").encode()
        code, sse = post("/v1/audio/transcriptions", body,
                         f"multipart/form-data; boundary={boundary}")
        wall = time.perf_counter() - t0
        got = counts()
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    data = [line[6:] for line in sse.decode().split("\n") if line.startswith("data: ")]
    kinds = [json.loads(d)["type"] for d in data[:-1]]
    log(f"phase http: /v1/transcribe x4 at once (5, 15, 30, 92 s): codes "
        f"{[r[0] for r in replies]}, ms {[round(r[2], 1) for r in replies]}; SSE "
        f"{code}, {kinds.count('transcript.text.delta')} deltas, last events "
        f"{kinds[-1:] + data[-1:]}; wall {wall * 1e3:.1f} ms; healthz {health}")
    if any(r[0] != 200 for r in replies) or code != 200:
        raise AssertionError("an HTTP request was not answered 200")
    if data[-1] != "[DONE]" or kinds[-1] != "transcript.text.done":
        raise AssertionError("the SSE stream did not end with done, [DONE]")
    if health["status"] != "ok" or health["engine"]["completed"] < 5:
        raise AssertionError(f"healthz: {health}")
    check_launches("HTTP path", got,
                   health["engine"]["rounds"] * ENGINE_KW["round_tokens"], groups)
    return got


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from qwen3_asr_tpu.config import ASRModelConfig
    from qwen3_asr_tpu_torch.models import generate as gen_mod
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_cuda_kernels
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.runtime.params import assert_on_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
        "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build: {build.build_seconds or 0.0:.1f} s (library load "
        f"{time.perf_counter() - t0:.1f} s), "
        f"source hash {build.source_hash()}")
    if not has_cuda_kernels():
        raise RuntimeError("the kernel library's probe failed on this device")

    f_c = phase_flash(True, 1280, 16, 8, 128, [1216])
    f_b = phase_flash(False, 1196, 14, 14, 64, [1196])
    f_cb = phase_flash(True, 1280, 16, 8, 128, [1216, 904, 512, 77])
    f_bb = phase_flash(False, 1235, 14, 14, 64, [1235, 1196, 650, 130])

    t0 = time.perf_counter()
    asr = Qwen3ASR(quantize="int4", kv_cache="int8", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    torch.cuda.synchronize()
    log(f"load_random + int8pc + int4 pack: {time.perf_counter() - t0:.1f} s")
    # fixed-length decode, as the bench runs it: EOS outside the argmax range
    asr.cfg = dataclasses.replace(
        asr.cfg, decoder=dataclasses.replace(asr.cfg.decoder, eos_token_id=-1))
    m = phase_mega(asr.cfg, asr.params["decoder"])

    caches = []
    make_cache = gen_mod.init_kv_cache

    def recording_cache(*a, **k):
        c = make_cache(*a, **k)
        caches.append(c)
        return c

    gen_mod.init_kv_cache = recording_cache
    asr.transcribe(pcm(5, 1), TranscribeParams(max_tokens=8))   # warm-up
    torch.cuda.synchronize()

    reset_counts()
    results = []
    for seconds, max_tokens in REQUESTS:
        t0 = time.perf_counter()
        r = asr.transcribe(pcm(seconds), TranscribeParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
        results.append((seconds, max_tokens, (time.perf_counter() - t0) * 1e3, r))
    launches = counts()
    gen_mod.init_kv_cache = make_cache
    for seconds, max_tokens, ms, r in results:
        log(f"request {seconds} s: {ms:.1f} ms, {len(r.tokens)} tokens "
            f"(max {max_tokens}), success={r.success}")

    # decode ms/step on the 92 s request: (323 tokens - 1 token) / 322 steps
    t0 = time.perf_counter()
    asr.transcribe(pcm(92), TranscribeParams(max_tokens=1))
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    per_step = (results[-1][2] - one) / (REQUESTS[-1][1] - 1)
    log(f"92 s request with 1 token: {one:.1f} ms; decode {per_step:.4f} ms/step")

    # checks on the main path
    assert_on_device(asr.params, "cuda")
    for c in caches:
        assert_on_device(c, "cuda")
    want_flash = asr.cfg.decoder.n_layers * len(REQUESTS)
    want_mega = sum(mt - 1 for _, mt in REQUESTS)
    log(f"launches on the main path: flash {launches['flash']} (want "
        f"{want_flash}), megakernel steps {launches['mega']} (want {want_mega})")
    if (launches["flash"] != want_flash or launches["mega"] != want_mega
            or launches["mega_batch"]):
        raise AssertionError(f"launch counts {launches}")
    V = asr.cfg.decoder.vocab_size
    for seconds, max_tokens, _, r in results:
        if not r.success or len(r.tokens) != max_tokens:
            raise AssertionError(f"{seconds} s request: {len(r.tokens)} tokens")
        if not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"{seconds} s request: token out of range")
    check_tokens_vs_twins(asr, pcm(5), results[0][3].tokens[:16])

    k3 = phase_mega_batch(asr.cfg.decoder, asr.params["decoder"]["mega"])
    engine_tps, engine_launches = phase_engine(asr)
    http_launches = phase_http(asr)
    total = {k: launches[k] + engine_launches[k] + http_launches[k] for k in launches}
    log(f"pool decode {engine_tps:.1f} tokens/s; launches over the three paths {total}")

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "qwen3_asr_tpu_torch/csrc/flash_attention.cu",
         "replaces": "qwen3_asr_tpu/ops/pallas_attention.py:32",
         "launches": total["flash"],
         "max_abs_err": max(f[0] for f in (f_c, f_b, f_cb, f_bb)),
         "ms": f_c[1], "plain_ms": f_c[2]},
        {"name": "mega_decode_step_i8", "route": "cuda",
         "source": "qwen3_asr_tpu_torch/csrc/megakernel.cu",
         "replaces": "qwen3_asr_tpu/ops/megakernel.py:460",
         "launches": total["mega"], "max_abs_err": m[0],
         "ms": m[1], "plain_ms": m[2]},
        {"name": "mega_decode_step_batch", "route": "cuda",
         "source": "qwen3_asr_tpu_torch/csrc/megakernel_batch.cu",
         "replaces": "qwen3_asr_tpu/ops/megakernel_batch.py:110",
         "launches": total["mega_batch"], "max_abs_err": k3[0],
         "ms": k3[1], "plain_ms": k3[2]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # report and fail: no result line
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
