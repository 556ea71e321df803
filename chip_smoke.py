"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `qwen3_asr_tpu_torch/csrc` (into
`build/torch_kernels/`) and holds each kernel against its plain PyTorch
twin at the shapes of the main paths: flash attention (K2) single and
batched (timed beside `scaled_dot_product_attention` at the same shapes),
the decode step (K1), the batched decode step (K3), which must equal K1 run
on each row's slab bit for bit, the Q8_0 products K5 / K6 / K7 at the decode
step's T = 1 and a 5 s prompt's T, and the decode attention K4 with a bf16
and an int8 cache. Then, at the full Qwen3-ASR-0.6B width with seeded random
weights (EOS disabled), it drives four paths, each with the launch counts
set to 0 just before it and read just after:

1. `Qwen3ASR(quantize="int4", kv_cache="int8").transcribe` on three int16
   requests of 5 s, 30 s and 92 s;
2. the per-layer decode step: `Qwen3ASR(quantize="q8_0")` with a bf16 cache
   (5 s and 92 s) and an int8 cache (5 s), and `Qwen3ASR(quantize=False)`
   (dense bf16 weights, bf16 cache, 5 s), each request a window of its own,
   after each layer of the q8_0 step has been held against the twins on the
   twins' input;
3. the continuous-batching engine on 8 requests admitted in two groups of
   4 (the second mid-flight), whose tokens must equal `transcribe_batch`'s
   on the same groups (that closed-batch reference is a window of its own,
   its counts reset before it and checked after it);
4. `ASRServer` in continuous mode behind the HTTP front end: 4 concurrent
   `/v1/transcribe` requests, one SSE `/v1/audio/transcriptions` request
   and `/healthz`.

It checks that every parameter and cache tensor of paths 1 and 2 is on the
GPU, that each kernel of a path ran there (launch counts against a formula
from the code), and that tokens agree with the twins' on a 5 s request of
paths 1, 2 (q8_0 and dense) and 3.

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
# the per-layer decode path: (quantize, kv_cache, seconds, max_tokens)
SLICE_REQUESTS = (("q8_0", "bf16", 5, 64), ("q8_0", "bf16", 92, 323),
                  ("q8_0", "int8", 5, 64), (False, "bf16", 5, 64))
# Q8_0 kernels vs twin. f32 dequant: the same f32 products summed in another
# order, rel L2 <= Q8_F32_REL. bf16 dequant: a normed activation can round to
# the other bf16 neighbour, rel L2 <= Q8_BF16_REL and |err| <= Q8_BF16_ATOL x
# the output's largest magnitude.
Q8_F32_REL, Q8_BF16_REL, Q8_BF16_ATOL = 1e-5, 1e-4, 1e-3
# Decode attention vs twin: the same f32 math in another order, |err| <=
# DA_ATOL x scale + DA_RTOL x |ref| elementwise.
DA_RTOL, DA_ATOL = 1e-4, 1e-5
# One layer of the q8_0 decode step on the twin's input: h and the fresh K/V
# rows rel L2 <= Q8_LAYER_REL (a bf16 rounding of qkv or of the attention
# row that lands on the other side moves the layer's output by ~1e-3; one
# live cache row dropped by K4 moves it by ~3e-2).
Q8_LAYER_REL = 5e-3
# Peaks of an H100 SXM (NVIDIA's data sheet) for the bounds: HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS, BF16_FLOPS, F32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12
WEIGHT_KEYS = ("qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
               "head_q", "head_s")


def int4_step_bound(pack, dcfg, positions) -> tuple[float, str]:
    """K1 / K3 step: the int4 weights and scales once, each row's live int8
    cache (K and V rows < pos and their scales, all layers) and its fresh row;
    2 operations per weight and 4 D per (head, cached row) per row."""
    L, NH, NKV, D = dcfg.n_layers, dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    w_bytes = sum(pack[k].numel() * pack[k].element_size() for k in WEIGHT_KEYS)
    n_w = sum(2 * pack[k].numel() for k in WEIGHT_KEYS if k.endswith("_q"))
    row = L * (2 * NKV * D + 2 * NKV * 4)
    nbytes = w_bytes + sum((p + 1) * row for p in positions)
    ops = 2.0 * n_w * len(positions) + sum(4.0 * L * NH * D * p for p in positions)
    return bound(nbytes, ops, INT8_OPS)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over n runs between CUDA events (for a
    kernel shorter than its launch from Python this is the host's cost)."""
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


def graph_ms(fn, per_graph: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds of one fn() with the host's launch cost taken
    out: fn() is captured per_graph times back to back in one CUDA graph,
    which is replayed reps times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * per_graph)


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
    # the library yardstick: one scaled_dot_product_attention call with the
    # same mask (causal and keys < valid[b]) on the same inputs, GQA native
    col = torch.arange(T, device="cuda")
    mask = col[None, None, None, :] < vl[:, None, None, None]
    if causal:
        mask = mask & (col[None, :] <= col[:, None])[None, None]
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)

    lib_err = float((sdpa().transpose(1, 2).float() - ref.float()).abs().max())
    lib = cuda_ms(sdpa, 20)
    # work this run's data needs: (query, key) pairs under the mask, 4 D
    # FLOP each per head (scores and the weighted sum); q, k, v and the
    # output once each, bf16
    pairs = sum(min(t + 1, n) if causal else n for n in valid for t in range(T))
    ops = 4.0 * D * NH * pairs
    nbytes = 2.0 * B * T * D * (2 * NH + 2 * NKV)
    b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
    name = "causal" if causal else "bidirectional"
    log(f"phase flash {name} B={B} T={T} NH={NH} NKV={NKV} D={D} valid={valid}: "
        f"max_abs_err={err:.3e} worst |err| / (atol + rtol |ref|) "
        f"{ratio:.4f}; kernel {ms:.4f} ms, twin {plain:.4f} ms, sdpa {lib:.4f} ms "
        f"(max_abs_err vs twin {lib_err:.3e}); bound {b_ms:.4f} ms ({b_by}: "
        f"{ops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    if not ratio <= 1.0:
        raise AssertionError(f"flash {name}: |err| exceeds {FLASH_ATOL} + "
                             f"{FLASH_RTOL} |ref| ({ratio:.3f}x)")
    return err, ms, plain, lib, b_ms, b_by


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
    b_ms, b_by = int4_step_bound(pack, dcfg, [pos0 + steps])
    log(f"  K1 bound at pos {pos0 + steps}: {b_ms:.4f} ms ({b_by})")
    return max_err, ms, plain, b_ms, b_by


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
    b_ms, b_by = int4_step_bound(pack, dcfg, [min(p, pos_end) for p in _spread(B)])
    log(f"phase K3 times (ms/step): " + ", ".join(
        f"B={nb} {t:.4f}" for nb, t in times.items())
        + f"; K1 {single:.4f} (B x K1 at B=8: {8 * single:.4f}); "
        f"plain at B=8 {plain:.4f}; bound at B=8 {b_ms:.4f} ms ({b_by})")
    return max_err, times[8], plain, b_ms, b_by


def check_tokens_vs_twins(asr, samples, tokens, mel_bucket: int = 0):
    """The kernel path's tokens on one request vs the twins, teacher-forced
    on those tokens: each is the twin's argmax or within NEAR_TIE_TOL.
    mel_bucket > 0: the frontend is the bucketed batched one (the serving
    path), with the flash kernel's plain version in its encoder too. A tree
    without the int4 pack runs the per-layer decode step with the twins of
    K4-K7."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.audio.mel import mel_device
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models import encoder as emod
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
    from qwen3_asr_tpu_torch.models.generate import decode_token
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.pipeline.asr import frontend_feats_batch
    from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt

    cfg, dcfg, dec = asr.cfg, asr.cfg.decoder, asr.params["decoder"]
    mega = "mega" in dec
    with twins():
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
        cache = dmod.init_kv_cache(dcfg, S, "cuda", asr.cache_dtype)
        h0 = dmod.embed_with_audio(dec, torch.tensor(prompt, device="cuda"), feats,
                                   n_audio, off)
        h = dmod.decoder_forward(dec, dcfg, h0, cache, P)
        logits = [dmod.lm_logits(dec, dcfg, h[P - 1])]
        L, DKV = dcfg.n_layers, dcfg.n_kv_heads * dcfg.head_dim
        for i in range(1, len(tokens)):
            pos = P + i - 1
            t = torch.tensor([tokens[i - 1], 0], dtype=torch.int32, device="cuda")
            if mega:
                logits.append(mk.mega_decode_step_i8_ref(
                    dec["mega"], dcfg, t[:1], pos, cache["k"].view(L, S, DKV),
                    cache["v"].view(L, S, DKV), cache["k_s"], cache["v_s"],
                    return_logits=True)[2])
            else:
                logits.append(decode_token(dec, dcfg, cache, t, 1, pos))
    gaps = []
    for lg, tok in zip(logits, tokens):
        best = int(torch.argmax(lg))
        gaps.append(float(lg[best] - lg[tok]))
    agree = sum(g == 0.0 for g in gaps)
    log(f"{'int4' if mega else asr.quantize or 'dense'} path vs twins "
        f"({len(samples) / 16000:.0f} s request, {len(tokens)} tokens): {agree} "
        f"argmax-equal, worst gap {max(gaps):.4f}")
    if max(gaps) > NEAR_TIE_TOL or not np.isfinite(gaps).all():
        raise AssertionError("main-path tokens disagree with the twins")


def prompt_rows(seconds: float) -> int:
    """Rows of the exact-length prompt of a request (the fused path's P)."""
    from qwen3_asr_tpu_torch.audio.mel import num_mel_frames
    from qwen3_asr_tpu_torch.config import DecoderConfig
    from qwen3_asr_tpu_torch.models.e2e import expected_n_audio
    from qwen3_asr_tpu_torch.text.prompt import build_asr_prompt

    n_audio = expected_n_audio(num_mel_frames(int(seconds * 16000)))
    return len(build_asr_prompt(n_audio, DecoderConfig()))


def _q8_bytes(n_in: int, n_out: int) -> int:
    """Bytes of a Q8_0 weight: int8 codes and one f32 scale per 32 rows."""
    return n_in * n_out + (n_in // 32) * n_out * 4


def phase_q8(dec, dcfg, Ts) -> dict:
    """K5 (Wo), K6 (QKV and the lm head) and K7 against their twins on layer
    0's Q8_0 weights of the model, at each T of Ts. -> {(name, T): (max_abs_err,
    kernel ms, twin ms, bound ms, bound_by)}."""
    import torch

    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    lay = dec["layers"]

    def leaf(key):
        return {k: v[0] for k, v in lay[key].items()}

    H, FF, eps = dcfg.hidden_size, dcfg.intermediate_size, dcfg.rms_norm_eps
    DQ = dcfg.n_heads * dcfg.head_dim
    wqkv, wo, gu, dn, head = (leaf("wqkv"), leaf("wo"), leaf("w_gate_up"),
                              leaf("w_down"), dec["lm_head_q8"])
    nw = lay["attn_norm"][0]
    g = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for T in Ts:
        x = torch.randn(T, H, generator=g, device="cuda").to(torch.bfloat16)
        xa = torch.randn(T, DQ, generator=g, device="cuda").to(torch.bfloat16)
        cases = []
        for name, w, xx, fn, ref in (
                ("K5 q8_matmul (Wo)", wo, xa,
                 lambda: q8.q8_matmul(xa, wo["q8:q"], wo["q8:s"]),
                 lambda: q8.q8_matmul_ref(xa, wo["q8:q"], wo["q8:s"])),
                ("K6 q8_norm_matmul (QKV)", wqkv, x,
                 lambda: q8.q8_norm_matmul(x, wqkv, nw, eps),
                 lambda: q8.q8_norm_matmul_ref(x, wqkv["q8:q"], wqkv["q8:s"], nw, eps)),
                ("K6 q8_norm_matmul (lm head)", head, x,
                 lambda: q8.q8_norm_matmul(x, head, nw, eps),
                 lambda: q8.q8_norm_matmul_ref(x, head["q8:q"], head["q8:s"], nw, eps))):
            n_in, n_out = w["q8:q"].shape
            bf16 = q8.deq_bf16_for(n_out)
            nbytes = _q8_bytes(n_in, n_out) + 2 * T * n_in + 4 * T * n_out
            cases.append((name, fn, ref, bf16, nbytes, 2.0 * T * n_in * n_out))
        n_w = H * 2 * FF + FF * H
        cases.append(("K7 q8_mlp", lambda: q8.q8_mlp(x, gu, dn, nw, eps, FF),
                      lambda: q8.q8_mlp_ref(x, gu["q8:q"], gu["q8:s"], dn["q8:q"],
                                            dn["q8:s"], nw, eps, FF),
                      True, _q8_bytes(H, 2 * FF) + _q8_bytes(FF, H) + 2 * T * H + 4 * T * H,
                      2.0 * T * n_w))
        for name, fn, ref, bf16, nbytes, ops in cases:
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float((got - want).norm() / want.norm())
            scale = float(want.abs().max())
            ms = graph_ms(fn)
            call = cuda_ms(fn, 20)
            plain = cuda_ms(ref, 3, warmup=1)
            b_ms, b_by = bound(nbytes, ops, BF16_FLOPS if bf16 else F32_FLOPS)
            log(f"phase {name} T={T} ({'bf16' if bf16 else 'f32'} dequant): "
                f"max_abs_err={err:.3e} rel_l2 {rel:.3e} (max |ref| {scale:.3f}); "
                f"kernel {ms:.4f} ms (graph; {call:.4f} ms a call from the host), "
                f"twin {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
            if not rel <= (Q8_BF16_REL if bf16 else Q8_F32_REL) or (
                    bf16 and not err <= Q8_BF16_ATOL * scale):
                raise AssertionError(f"{name} T={T} disagrees with its twin")
            out[(name, T)] = (err, ms, plain, b_ms, b_by)
    return out


def phase_decode_attention(dcfg, pos: int, S: int) -> dict:
    """K4 against its twin with a bf16 and an int8 cache of S rows, at
    offset = pos and at offset 0. -> {(cache, offset): (max_abs_err, kernel
    ms, twin ms, bound ms, bound_by)}."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows
    from qwen3_asr_tpu_torch.ops import decode_attention as da

    NH, NKV, D = dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for cache in ("bf16", "int8"):
        qkv = torch.randn(1, (NH + 2 * NKV) * D, generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn(S, NKV, D, generator=g, device="cuda")
        v = torch.randn(S, NKV, D, generator=g, device="cuda")
        qn, kn = ((1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)
                  for _ in range(2))
        kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=dcfg.rms_norm_eps,
                  theta=dcfg.rope_theta, scale=1.0 / float(np.sqrt(D)))
        if cache == "int8":
            (k, ks), (v, vs) = _quantize_kv_rows(k), _quantize_kv_rows(v)
            kw.update(k_scale=ks, v_scale=vs)
            row_bytes = 2 * NKV * D + 2 * NKV * 4
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            row_bytes = 4 * NKV * D
        for off in (pos, 0):
            args = (qkv, k, v, qn, kn, off, off)
            got, want = da.decode_attention(*args, **kw), da.decode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ratio = max(float(((a - b).abs() / (DA_ATOL * b.abs().max() + DA_RTOL * b.abs()))
                              .max()) for a, b in zip(got, want))
            ms = graph_ms(lambda: da.decode_attention(*args, **kw))
            call = cuda_ms(lambda: da.decode_attention(*args, **kw), 50)
            plain = cuda_ms(lambda: da.decode_attention_ref(*args, **kw), 5)
            nbytes = off * row_bytes + 2 * qkv.numel() + 4 * (NH + 2 * NKV) * D
            b_ms, b_by = bound(nbytes, 4.0 * NH * D * (off + 1), F32_FLOPS)
            log(f"phase K4 decode_attention {cache} cache S={S} offset=pos={off}: "
                f"max_abs_err={err:.3e} worst |err| / (atol + rtol |ref|) {ratio:.4f}; "
                f"kernel {ms:.4f} ms (graph; {call:.4f} ms a call from the host), twin "
                f"{plain:.4f} ms; bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
            if not ratio <= 1.0:
                raise AssertionError(f"decode attention ({cache}, offset {off}) "
                                     f"disagrees with its twin")
            out[(cache, off)] = (err, ms, plain, b_ms, b_by)
    return out


def phase_q8_layers(asr, pos: int) -> list[float]:
    """Each layer of the q8_0 decode step alone (a one-layer slice of the
    tree and the cache, bf16 cache rows < pos filled at random) on the twins'
    input to that layer: the kernels' output row and fresh K/V row against
    the twins'. -> h rel L2 per layer."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod

    dcfg, dec = asr.cfg.decoder, asr.params["decoder"]
    cfg1 = dataclasses.replace(dcfg, n_layers=1)
    g = torch.Generator(device="cuda").manual_seed(7)
    shape = (1, pos + 1, dcfg.n_kv_heads, dcfg.head_dim)
    x = dec["token_embd"][torch.tensor([1000], device="cuda")]
    rels = []
    for l in range(dcfg.n_layers):
        d1 = dict(dec, layers={k: ({kk: vv[l:l + 1] for kk, vv in v.items()}
                                   if isinstance(v, dict) else v[l:l + 1])
                               for k, v in dec["layers"].items()})
        fill = {n: (torch.randn(shape, generator=g, device="cuda") * 0.5).to(torch.bfloat16)
                for n in ("k", "v")}
        caches = [{n: t.clone() for n, t in fill.items()} for _ in range(2)]
        h = dmod.decoder_forward(d1, cfg1, x, caches[0], pos + 1, prefill=False,
                                 cache_offset=pos)
        with twins():
            r = dmod.decoder_forward(d1, cfg1, x, caches[1], pos + 1, prefill=False,
                                     cache_offset=pos)
        torch.cuda.synchronize()
        rel = _rel(h, r)
        fresh = max(_rel(caches[0][n][:, pos], caches[1][n][:, pos]) for n in ("k", "v"))
        if not (rel <= Q8_LAYER_REL and fresh <= Q8_LAYER_REL):
            raise AssertionError(f"q8_0 layer {l} on the same input: h rel L2 {rel:.3e}, "
                                 f"fresh K/V rel L2 {fresh:.3e}")
        if not all(torch.equal(caches[0][n][:, :pos], fill[n][:, :pos]) for n in ("k", "v")):
            raise AssertionError(f"q8_0 layer {l}: a cache row below pos changed")
        rels.append(rel)
        x = r
    log(f"phase q8_0 decode step, each layer alone on the twins' input (pos {pos}, "
        f"bf16 cache): h rel_l2 max {max(rels):.3e}, per layer: "
        + " ".join(f"{r:.1e}" for r in rels))
    return rels


def slice_launches(quantize, P: int, max_tokens: int, L: int) -> dict:
    """Launch counts of one request on the per-layer path, from the code:
    the prefill's 28 K2 (causal) and, at P <= 256 rows, 28 each of K6 (QKV),
    K5 (Wo) and K7; the first token's lm head (K6); then per decode step 28
    K4, and with Q8_0 weights 29 K6 (28 QKV + the head), 28 K5 and 28 K7.
    Dense weights launch no K5-K7."""
    steps = max_tokens - 1
    want = dict(no_launches(), flash=L, decode_attention=L * steps)
    if quantize:
        small = L if P <= 256 else 0
        want.update(q8_norm_matmul=(L + 1) * steps + 1 + small,
                    q8_matmul=L * steps + small, q8_mlp=L * steps + small)
    return want


def phase_slice(caches: list):
    """The per-layer decode path at full width (random weights, seed 0, EOS
    off): q8_0 weights with a bf16 cache (5 s / 64 tokens, 92 s / 323), with
    an int8 cache (5 s / 64), dense bf16 weights with a bf16 cache (5 s /
    64); each request a window of its own, checked against slice_launches.
    `caches` collects the KV caches the requests make. -> (launch counts
    summed over the windows, q8_0 decode ms/step of the 92 s request, the
    q8_0 model)."""
    import torch

    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.runtime.params import assert_on_device

    def load(quantize, kv_cache, like=None):
        asr = Qwen3ASR(quantize=quantize, kv_cache=kv_cache, device="cuda")
        if like is None:
            t0 = time.perf_counter()
            asr.load_random(ASRModelConfig(), seed=0)
            torch.cuda.synchronize()
            log(f"load_random, quantize={quantize!r}: {time.perf_counter() - t0:.1f} s")
        else:
            asr.cfg, asr.params = like.cfg, like.params
            asr.tokenizer, asr.filters_t = like.tokenizer, like.filters_t
        asr.cfg = dataclasses.replace(asr.cfg, decoder=dataclasses.replace(
            asr.cfg.decoder, eos_token_id=-1))
        assert_on_device(asr.params, "cuda")
        asr.transcribe(pcm(5, 1), TranscribeParams(max_tokens=4))   # warm-up
        return asr

    q8_bf16 = load("q8_0", "bf16")
    models = {("q8_0", "bf16"): q8_bf16, ("q8_0", "int8"): load("q8_0", "int8", q8_bf16),
              (False, "bf16"): load(False, "bf16")}
    L, V = q8_bf16.cfg.decoder.n_layers, q8_bf16.cfg.decoder.vocab_size
    phase_q8_layers(q8_bf16, 1248)
    total, tokens, ms_92 = no_launches(), {}, {}
    windows = [(q, kv, sec, mt) for q, kv, sec, mt in SLICE_REQUESTS] + [("q8_0", "bf16", 92, 1)]
    for quantize, kv_cache, seconds, max_tokens in windows:
        asr = models[(quantize, kv_cache)]
        n_caches = len(caches)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = asr.transcribe(pcm(seconds), TranscribeParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = counts()
        P = prompt_rows(seconds)
        want = slice_launches(quantize, P, max_tokens, L)
        log(f"request quantize={quantize!r} kv_cache={kv_cache} {seconds} s: {ms:.1f} ms, "
            f"{len(r.tokens)} tokens (max {max_tokens}), P={P}; launches {got}")
        if got != want:
            raise AssertionError(f"launch counts {got} != {want}")
        if not r.success or len(r.tokens) != max_tokens or not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"{seconds} s request: {len(r.tokens)} tokens or one "
                                 f"out of range")
        dt = torch.int8 if kv_cache == "int8" else torch.bfloat16
        if len(caches) != n_caches + 1 or caches[-1]["k"].dtype != dt:
            raise AssertionError("the request did not make one cache of its dtype")
        for k in got:
            total[k] += got[k]
        tokens[(quantize, kv_cache, seconds, max_tokens)] = r.tokens
        if seconds == 92:
            ms_92[max_tokens] = ms
    per_step = (ms_92[323] - ms_92[1]) / 322
    log(f"q8_0 92 s request: 323 tokens {ms_92[323]:.1f} ms, 1 token {ms_92[1]:.1f} ms; "
        f"decode {per_step:.4f} ms/step")
    check_tokens_vs_twins(q8_bf16, pcm(5), tokens[("q8_0", "bf16", 5, 64)][:16])
    check_tokens_vs_twins(models[(False, "bf16")], pcm(5),
                          tokens[(False, "bf16", 5, 64)][:16])
    del models
    return total, per_step, q8_bf16


ENGINE_REQUESTS = (5, 10, 15, 30, 30, 60, 92, 92)   # seconds; two groups of 4
ENGINE_KW = dict(pool=8, round_tokens=64, mel_bucket=500)
ENGINE_S, ENGINE_TOKENS = 1536, 128


def _wrappers() -> dict:
    """The kernels' wrappers by the names the launch counts use."""
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    return {"flash": fa.flash_attention_batch, "mega": mk.mega_decode_step_i8,
            "mega_batch": mb.mega_decode_step_batch,
            "decode_attention": da.decode_attention, "q8_matmul": q8.q8_matmul,
            "q8_norm_matmul": q8.q8_norm_matmul, "q8_mlp": q8.q8_mlp}


def counts() -> dict:
    """Launch counts of the kernels' wrappers."""
    return {k: w.launches for k, w in _wrappers().items()}


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def no_launches() -> dict:
    return {k: 0 for k in _wrappers()}


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    HBM_BPS and the operations over `peak`, and which of the two it is."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class twins:
    """Inside the block the decoder and encoder call the plain twins of K2
    and K4-K7 on the card (the Q8_0 wrappers' own path above 256 rows is no
    kernel and stays). Leaving it raises if any launch count moved: a call
    site left unpatched would compare a kernel with itself."""

    def __enter__(self):
        from qwen3_asr_tpu_torch.models import decoder as dmod
        from qwen3_asr_tpu_torch.models import encoder as emod
        from qwen3_asr_tpu_torch.ops import decode_attention as da
        from qwen3_asr_tpu_torch.ops import flash_attention as fa
        from qwen3_asr_tpu_torch.ops import q8_matmul as q8

        self._counts = counts()
        k5, k6, k7 = q8.q8_matmul, q8.q8_norm_matmul, q8.q8_mlp
        rows = q8._MAX_KERNEL_ROWS

        def t5(x, q, s):
            return q8.q8_matmul_ref(x, q, s) if x.shape[0] <= rows else k5(x, q, s)

        def t6(x, leaf, nw, eps):
            if x.shape[0] > rows:
                return k6(x, leaf, nw, eps)
            return q8.q8_norm_matmul_ref(x, leaf["q8:q"], leaf["q8:s"], nw, eps)

        def t7(x, gu, dn, nw, eps, n_ffn):
            if x.shape[0] > rows:
                return k7(x, gu, dn, nw, eps, n_ffn)
            return q8.q8_mlp_ref(x, gu["q8:q"], gu["q8:s"], dn["q8:q"], dn["q8:s"],
                                 nw, eps, n_ffn)

        self._saved = [(dmod, "flash_attention_batch", dmod.flash_attention_batch),
                       (emod, "flash_attention_batch", emod.flash_attention_batch),
                       (dmod, "decode_attention", dmod.decode_attention),
                       (dmod, "q8_norm_matmul", k6), (dmod, "q8_mlp", k7),
                       (q8, "q8_matmul", k5)]
        dmod.flash_attention_batch = emod.flash_attention_batch = fa.flash_attention_ref
        dmod.decode_attention = da.decode_attention_ref
        dmod.q8_norm_matmul, dmod.q8_mlp, q8.q8_matmul = t6, t7, t5
        return self

    def __exit__(self, exc_type, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        if exc_type is None and counts() != self._counts:
            raise AssertionError(f"a kernel launched inside twins(): launch counts "
                                 f"{self._counts} -> {counts()}")
        return False


def encoder_calls(groups) -> int:
    """Batched encoder calls of the bucketed frontend (one per distinct
    mel bucket of each admitted or transcribed group)."""
    from qwen3_asr_tpu_torch.audio.mel import num_mel_frames

    b = ENGINE_KW["mel_bucket"]
    return sum(len({-(-num_mel_frames(len(x)) // b) for x in g}) for g in groups)


def check_launches(what: str, got: dict, k3_steps: int, groups) -> None:
    """K3 = k3_steps; K2 = 28 per batched prefill (one per group) + 18 per
    batched encoder call; no K1 on these paths."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig

    cfg = ASRModelConfig()
    want = dict(no_launches(), flash=cfg.decoder.n_layers * len(groups)
                + cfg.encoder.n_layers * encoder_calls(groups), mega_batch=k3_steps)
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
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.models import generate as gen_mod
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_cuda_kernels
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.runtime.params import assert_on_device

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    log(card)
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
    da_ms = phase_decode_attention(ASRModelConfig().decoder, 1248, 1664)

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
    want = dict(no_launches(), flash=asr.cfg.decoder.n_layers * len(REQUESTS),
                mega=sum(mt - 1 for _, mt in REQUESTS))
    log(f"launches on the int4 path: {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches}")
    V = asr.cfg.decoder.vocab_size
    for seconds, max_tokens, _, r in results:
        if not r.success or len(r.tokens) != max_tokens:
            raise AssertionError(f"{seconds} s request: {len(r.tokens)} tokens")
        if not all(0 <= t < V for t in r.tokens):
            raise AssertionError(f"{seconds} s request: token out of range")
    check_tokens_vs_twins(asr, pcm(5), results[0][3].tokens[:16])

    k3 = phase_mega_batch(asr.cfg.decoder, asr.params["decoder"]["mega"])

    gen_mod.init_kv_cache = recording_cache
    try:
        slice_launches_, q8_step_ms, q8_asr = phase_slice(caches)
    finally:
        gen_mod.init_kv_cache = make_cache
    for c in caches:
        assert_on_device(c, "cuda")
    p5 = prompt_rows(5)
    q8k = phase_q8(q8_asr.params["decoder"], q8_asr.cfg.decoder, (1, p5))
    del q8_asr

    engine_tps, engine_launches = phase_engine(asr)
    http_launches = phase_http(asr)
    total = {k: launches[k] + slice_launches_[k] + engine_launches[k] + http_launches[k]
             for k in launches}
    log(f"pool decode {engine_tps:.1f} tokens/s; q8_0 decode {q8_step_ms:.4f} "
        f"ms/step; launches over the four paths {total}")

    def row(name, src, replaces, key, err, ms, plain, b_ms, b_by, lib=None):
        return {"name": name, "route": "cuda",
                "source": f"qwen3_asr_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": total[key], "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "twin_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib}

    head = ("K6 q8_norm_matmul (lm head)", 1)
    kernels = [
        row("mega_decode_step_i8", "megakernel.cu", "qwen3_asr_tpu/ops/megakernel.py:460",
            "mega", *m),
        row("flash_attention", "flash_attention.cu",
            "qwen3_asr_tpu/ops/pallas_attention.py:32", "flash",
            max(f[0] for f in (f_c, f_b, f_cb, f_bb)), f_c[1], f_c[2], f_c[4], f_c[5],
            lib=f_c[3]),
        row("mega_decode_step_batch", "megakernel_batch.cu",
            "qwen3_asr_tpu/ops/megakernel_batch.py:110", "mega_batch", *k3),
        row("decode_attention", "decode_attention.cu",
            "qwen3_asr_tpu/ops/decode_attention.py:65", "decode_attention",
            max(v[0] for v in da_ms.values()), *da_ms[("bf16", 1248)][1:]),
        row("q8_matmul", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:69", "q8_matmul",
            max(v[0] for k, v in q8k.items() if k[0].startswith("K5")),
            *q8k[("K5 q8_matmul (Wo)", 1)][1:]),
        row("q8_norm_matmul", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:173",
            "q8_norm_matmul", max(v[0] for k, v in q8k.items() if k[0].startswith("K6")),
            *q8k[head][1:]),
        row("q8_mlp", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:224", "q8_mlp",
            max(v[0] for k, v in q8k.items() if k[0].startswith("K7")),
            *q8k[("K7 q8_mlp", 1)][1:]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    log(card)
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
