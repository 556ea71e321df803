"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (sm_90).

    python3 chip_smoke.py

Builds the port's CUDA kernels from `qwen3_asr_tpu_torch/csrc` (into
`build/torch_kernels/`) and holds each kernel against its plain PyTorch
twin at the shapes of the main paths: flash attention (K2, on the tensor
cores) single and batched (timed beside `scaled_dot_product_attention` at
the same shapes; also at the forced aligner's causal T 2,944, valid 2,845,
and a batch of four valid lengths), the capability probe (K8), the decode
step (K1) in its six modes ({int4, int8
weights} x {int8, bf16, int4 KV cache}: teacher-forced steps, an int4 step
keeping the other nibble of its byte row at even and odd positions, and
every layer alone on the twin's input; timed as the decode loops run it,
replayed from its CUDA graph) and at a long context (S 8,192, pos
7,996..7,999, on each cache), K1 replayed from its CUDA graph against eager
steps on the CLI default mode (64 steps each, bit for bit; ms/step and the
host's enqueue both ways, with programmatic dependent launch on and off),
the batched decode step (K3) on either pack at B 8, 13 and 16 (one and two
8-row MMA n-tiles), whose rows must equal K1 run on each row's slab bit for
bit, timed eager and from a CUDA graph at B 1 / 4 / 8 / 16 with a
torch.profiler split at B 8, and one of its products alone against
`torch._int_mm` (int32 sums equal), the Q8_0 products K5 / K6 / K7 at the decode
step's T = 1, the batched step's T 4 / 8 / 16 and a 5 s prompt's T (every
row torch.equal to its one-row launch), the decode attention K4 with a bf16 and
an int8 cache, and the weight-stream microbenchmarks K9-K11 (every integer
mode exact, the nibble-unpack probe bit-equal; `torch.Tensor.sum` over the
same bytes beside the read modes). Then, at the full Qwen3-ASR-0.6B width
with seeded random weights (EOS disabled), it drives the paths, each with
the launch counts set to 0 just before it and read just after:

1. `Qwen3ASR(quantize="int4", kv_cache="int8").transcribe` on three int16
   requests of 5 s, 30 s and 92 s, and the int4 pack over a bf16 cache on a
   5 s request (`--quantize int4` without `--kv-int8`);
2. the per-layer decode step: `Qwen3ASR(quantize="q8_0")` with a bf16 cache
   (5 s and 92 s) and an int8 cache (5 s), and `Qwen3ASR(quantize=False)`
   (dense bf16 weights, bf16 cache, 5 s), each request a window of its own,
   after each layer of the q8_0 step has been held against the twins on the
   twins' input;
3. the CLI's default configuration, `Qwen3ASR(quantize="auto")` (int8pc ->
   the int8 pack, bf16 cache): 5 s / 64, 92 s / 323 and 92 s / 1 tokens on
   the fused path and on the staged one, whose tokens must be equal; then
   its prefill's four fused passes (`phase_prefill_passes`) against their
   twins at T 80, 730, 1,280 and a server batch of 6 x 405 rows, each
   layer and the 28-layer stack against the eager chain, ms and device
   operations a prefill both ways, no host-device sync, 28 fused layers a
   request;
4. the server's default configuration (auto with the int8 cache): four
   requests in one closed batch (K3 on the int8 pack) and a lone one (K1),
   tokens equal to `transcribe_batch`'s and `transcribe`'s;
5. the continuous-batching engine (int4) on 8 requests admitted in two
   groups of 4 (the second mid-flight), whose tokens must equal
   `transcribe_batch`'s on the same groups (that closed-batch reference is a
   window of its own, its counts reset before it and checked after it);
6. `ASRServer` in continuous mode behind the HTTP front end: 4 concurrent
   `/v1/transcribe` requests, one SSE `/v1/audio/transcriptions` request
   and `/healthz`;
7. the int4 KV cache (`--kv-int4`): `Qwen3ASR(quantize=q,
   kv_cache="int4").transcribe` for q = int4, auto and int8pc, K1's int4
   entry once per decode step, tokens against the twins;
8. the streaming decode path (`--progress`, a progress callback) for the
   auto path and for int4 weights with the int4 cache: tokens equal to
   `transcribe`'s without the callback, one callback per token, decode
   ms/step beside `generate_greedy`'s;
9. `ASRServer --kv-cache int4` (closed batches) behind HTTP: a lone
   `/v1/transcribe` request and a lone SSE stream outside any pool, text
   equal to `transcribe`'s;
10. the forced aligner, Qwen3-ForcedAligner-0.6B at full width and depth,
   on bench_align.py's 92 s / 183-word workload (`phase_aligner`): `align`
   staged, bucketed and fused (28 K2 launches each, none in the windowed
   encoder), every layer of the NAR pass against the twins and the
   classes at the <ts> rows against theirs under the near-tie rule, the
   windowed encoder's attention against masked full attention,
   `align_batch` of four against single passes, stage times (dense and
   quantize="auto"), `transcribe_and_align`, and `ASRServer(aligner=...)`
   behind HTTP (/v1/align, the OpenAI route's srt and word timestamps);
11. sampled decoding (`phase_sampling`, `TranscribeParams(temperature,
   top_k, top_p, seed)`, the bench's 92 s audio) on the auto path (K1,
   int8 pack, bf16 KV), the int4 pack with the int8 and the int4 cache, and
   q8_0 (K4-K7): temperature 0 and top_k 1 against greedy, the same seed
   twice and another seed, a request a launch window, its tokens inside the
   twins' kept sets and its head's rows against the twins' h, sampled and
   greedy ms/step;
12. greedy self-speculation (`phase_spec`, `generate_greedy_spec`, 92 s /
   323 tokens) on the int8 and the int4 pack at k 1, 4 and 8, each run a
   window (K1 = drafted tokens), tokens against the per-layer int8pc greedy
   sequence, rounds and acceptance, ms per emitted token; one request with
   a cache past S 8,192;
13. the server (auto, int8 KV) behind HTTP with sampled OpenAI requests
   beside a greedy batch and the JAX package's 400s, and the CLI's
   `--temperature 0.7 --seed 3` and `--spec-k 4` in this process;
14. batches in every mode (`phase_batch_modes`): K4's batched mode (rows
   torch.equal to one-row launches) and K3 over a bf16 cache (rows equal to
   K1 bf16) at B 8, 13 and 16, the per-layer step at B 8 against single rows
   (every row and step torch.equal),
   `transcribe_batch` of four requests in q8_0 + bf16 / int8 KV, dense +
   bf16 and auto + bf16 (each a window; auto rows equal to `transcribe`'s)
   against the same requests one at a time, and the server's closed batch
   of four over HTTP with `--kv-cache bf16` and `--quantize q8_0`, one
   `transcribe_batch` each.

It checks that every parameter and cache tensor of paths 1 and 2 is on the
GPU, that each kernel of a path ran there (launch counts against a formula
from the code; a window also counts the decoder prefill's layers by path,
`_prefill_layers.fused_layers` / `.eager_layers`, and each prefill on
int8pc leaves must launch the four fused passes once a layer as
`prefill_want` says), and that tokens agree with the twins' on a 5 s
request of paths 1-5 and 7.

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
# A bf16 cache's fresh rows: every value within BF16_ROW_FRAC of its head
# row's largest magnitude (int8 codes within one step of amax / 127 differ by
# less than two steps: the same bound in the rows' own units).
BF16_ROW_FRAC = 2 / 127
# One layer alone on the same input (both get the twin's input to that
# layer): its fresh cache rows agree as above and h rel L2 <= MEGA_LAYER_REL.
# h is bit-exact unless an attention output rounds the other way (~4e-3).
MEGA_LAYER_REL = 1e-2
FLOOR_STEPS = 3         # steps on which the twin also runs on the CPU
MEGA_TIMED_POS = 1248   # the cache row of K1's timed step (S = 1,664)
LONG_S, LONG_POS = 8192, 8000   # K1's long-context phase: S and its timed row
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
Q8_ROWS = (1, 4, 8, 16)   # phase_q8's T besides a 5 s prompt's rows
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


def mega_step_bound(pack, dcfg, positions, kv: str = "int8") -> tuple[float, str]:
    """K1 / K3 step over rows at `positions`: profile_decode.step_bound's
    bytes and operations (the pack once, each row's live cache and fresh
    row) against HBM_BPS and INT8_OPS."""
    from qwen3_asr_tpu_torch.profile_decode import step_bound

    return bound(*step_bound(pack, dcfg, positions, kv), INT8_OPS)


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


def tparams(max_tokens: int, **kw):
    """TranscribeParams of the CLI's default single-request path (fused),
    the stderr timing block off."""
    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams

    return TranscribeParams(max_tokens=max_tokens, **{"fused": True, "print_timing": False,
                                                      **kw})


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


def _codes(c, pos: int):
    """Cache row pos of every layer as int32 codes [L, DKV]: int8 rows, or
    the nibble of byte row pos // 2 of int4 pairs, sign-extended."""
    import torch

    if c.dtype != torch.uint8:
        return c[:, pos].int()
    n = (c[:, pos // 2].int() >> (4 * (pos % 2))) & 0xF
    return n - 16 * (n >= 8).int()


def _bad_cache_layers(got, want, pos: int) -> list[int]:
    """Layers whose fresh row `pos` breaks the cache rule against the twin's.
    got/want: (k, v, k_s, v_s) [L, S, ...] (int4 pairs [L, S/2, DKV]). int8
    and int4: codes within one on <= CACHE_CODE_FRAC of entries, scales at
    CACHE_SCALE_RTOL; bf16 (no scales): every value within BF16_ROW_FRAC of
    its head row's largest magnitude, the most the int8 rule admits."""
    import torch

    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    if got[2] is None:
        from qwen3_asr_tpu_torch.config import DecoderConfig

        L, D = got[0].shape[0], DecoderConfig().head_dim
        for a, b in zip(got[:2], want[:2]):
            ha = a[:, pos].float().reshape(L, -1, D)
            hb = b[:, pos].float().reshape(L, -1, D)
            over = (ha - hb).abs() > BF16_ROW_FRAC * hb.abs().amax(dim=2, keepdim=True)
            bad |= over.reshape(L, -1).any(dim=1)
        return torch.nonzero(bad).flatten().tolist()
    for a, b in zip(got[:2], want[:2]):
        d = (_codes(a, pos) - _codes(b, pos)).abs()
        bad |= (d.amax(dim=1) > 1) | ((d > 0).float().mean(dim=1) > CACHE_CODE_FRAC)
    for a, b in zip(got[2:], want[2:]):
        rel = (a[:, pos] - b[:, pos]).abs() / b[:, pos].abs()
        bad |= rel.amax(dim=1) > CACHE_SCALE_RTOL
    return torch.nonzero(bad).flatten().tolist()


def _filled_cache(dcfg, S: int, n: int, g, kv: str = "int8"):
    """(k, v, k_s, v_s) [L, S, ...] with rows < n drawn from N(0, 0.25):
    int8 codes and scales, int4 pairs [L, S/2, ...] and scales (the int8
    rows packed by pack_kv_int4), or bf16 rows and no scales (None)."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows
    from qwen3_asr_tpu_torch.ops.megakernel import pack_kv_int4

    L, NKV, D = dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    out = []
    for _ in range(2):
        x = torch.randn(L * n, NKV, D, generator=g, device="cuda") * 0.5
        if kv == "bf16":
            c = torch.zeros(L, S, NKV * D, dtype=torch.bfloat16, device="cuda")
            c[:, :n] = x.reshape(L, n, NKV * D).to(torch.bfloat16)
            out += [c, None]
            continue
        q, s = _quantize_kv_rows(x)
        c = torch.zeros(L, S, NKV * D, dtype=torch.int8, device="cuda")
        sc = torch.zeros(L, S, NKV, dtype=torch.float32, device="cuda")
        c[:, :n] = q.reshape(L, n, NKV * D)
        sc[:, :n] = s.reshape(L, n, NKV)
        out += list(pack_kv_int4(c, sc)) if kv == "int4" else [c, sc]
    return out[0], out[2], out[1], out[3]


def _clone(ts):
    return [None if t is None else t.clone() for t in ts]


def _upto(ts, pos: int):
    """The cache rows <= pos of (k, v, k_s, v_s) (int4 pairs: byte rows <=
    pos // 2), on the CPU."""
    import torch

    return [None if t is None else
            t[:, :pos // 2 + 1 if t.dtype == torch.uint8 else pos + 1].cpu() for t in ts]


def _sync_fresh(got, ref, pos: int) -> None:
    """The twin's cache copy takes the kernel's fresh row at pos, once it
    has been compared. For int4 pairs the byte row pos // 2 is taken whole,
    after checking that the kernel kept its other nibble (the twin keeps
    it: tests/test_torch_kv4.py)."""
    import torch

    for a, b in zip(got, ref):
        if a is None:
            continue
        if a.dtype != torch.uint8:
            b[:, pos] = a[:, pos]
            continue
        r, keep = pos // 2, 0xF0 if pos % 2 == 0 else 0x0F
        if not torch.equal(a[:, r] & keep, b[:, r] & keep):
            raise AssertionError(f"int4 cache: the step at pos {pos} changed the other "
                                 f"nibble of byte row {r}")
        b[:, r] = a[:, r]


def mode_name(pack, kv: str) -> str:
    from qwen3_asr_tpu_torch.ops.megakernel import weight_bits

    return f"int{weight_bits(pack)} weights, {kv} KV"


def phase_mega(cfg, dec, kv: str = "int8", steps: int = 32,
               floor_steps: int = FLOOR_STEPS, S: int = 1664,
               pos_end: int = MEGA_TIMED_POS, layers: bool = True):
    """K1 on the tree's pack over an int8, bf16 or int4 cache against the
    twin, teacher-forced: `steps` steps from a prefilled cache of S rows up
    to pos_end, where at every step both get the same token and the same
    cache (the twin's copy takes the kernel's fresh rows after each step,
    once they have been compared; an int4 step must keep the other nibble of
    its byte row), and after the last step the whole caches must be equal
    (no stray write); the twin also on the CPU for `floor_steps` steps. Then
    (layers=True) every layer alone on the same input, the kernel's ms per
    step at pos_end (CUDA events) beside the host's enqueue time per step,
    and the twin's."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk

    dcfg = cfg.decoder
    pack = dec["mega"]
    name = mode_name(pack, kv)
    pos0 = pos_end - steps
    got = _filled_cache(dcfg, S, pos0, torch.Generator(device="cuda").manual_seed(1), kv)
    ref = _clone(got)
    step = mk.DecodeStep(pack, dcfg, *got)
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    tok = torch.tensor([1000], dtype=torch.int32, device="cuda")
    cpu_pack = {k: v.cpu() for k, v in pack.items()} if floor_steps else None
    max_err, rels, floors, mism, worst_gap = 0.0, [], [], 0, 0.0
    for i in range(steps):
        pos = pos0 + i
        if i < floor_steps:  # the twin on the CPU, on the same inputs
            cpu_h = mk.mega_decode_step_ref(cpu_pack, dcfg, tok.cpu(), pos,
                                            *_upto(ref, pos))[1]
        step(tok, pos, out)
        rt, rh, logits = mk.mega_decode_step_ref(
            pack, dcfg, tok, pos, *ref, return_logits=True)
        torch.cuda.synchronize()
        max_err = max(max_err, float((step.h - rh).abs().max()))
        rels.append(_rel(step.h, rh))
        if i < floor_steps:
            floors.append(_rel(cpu_h, rh.cpu()))
        got_t, want_t = int(out[0]), int(rt[0])
        if got_t != want_t:
            mism += 1
            worst_gap = max(worst_gap, float(logits[want_t] - logits[got_t]))
        bad = _bad_cache_layers(got, ref, pos)
        if bad and (rels[-1] == 0.0 or bad[0] == 0):
            raise AssertionError(f"mega ({name}) step {i} (h rel L2 {rels[-1]:.4f}): "
                                 f"fresh cache rows of layers {bad} differ")
        _sync_fresh(got, ref, pos)
        tok = rt.clone()
    if not all(a is None or torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"mega ({name}): the kernel's caches differ from the twin's "
                             f"outside the fresh rows after {steps} steps")
    n_exact = sum(r == 0.0 for r in rels)
    layer_rels = (phase_mega_layers(dcfg, pack, got, ref, pos0 + steps, tok) if layers
                  else [0.0])
    ms, enqueue = graphed_ms(step, tok, pos0 + steps)
    plain = cuda_ms(lambda: mk.mega_decode_step_ref(
        pack, dcfg, tok, pos0 + steps, *ref), 3, warmup=1)
    floor_txt = (f"twin cpu vs twin cuda rel_l2(h) {', '.join(f'{f:.4f}' for f in floors)}; "
                 if floors else "")
    log(f"phase megakernel ({name}) S={S} pos={pos0}..{pos0 + steps - 1}: "
        f"max_abs_err(h)={max_err:.3e} rel_l2(h) max {max(rels):.4f}, "
        f"bit-exact on {n_exact}/{steps} steps; {floor_txt}token "
        f"mismatches={mism}/{steps} (worst twin logit gap {worst_gap:.4f}); "
        f"kernel {ms:.4f} ms/step graphed (host enqueue {enqueue:.4f} ms/step), "
        f"twin {plain:.4f} ms/step")
    log("  rel_l2(h) per step: " + " ".join(f"{r:.4f}" for r in rels))
    if layers:
        log(f"  one layer on the same input, pos={pos0 + steps}: rel_l2(h) max "
            f"{max(layer_rels):.3e}, per layer: "
            + " ".join(f"{r:.1e}" for r in layer_rels))
    if worst_gap > NEAR_TIE_TOL:
        raise AssertionError(f"megakernel ({name}) tokens disagree with the twin")
    if not max(rels) <= MEGA_H_REL:
        raise AssertionError(f"megakernel ({name}) h rel_l2 {max(rels)} > {MEGA_H_REL}")
    if 2 * n_exact < steps:
        raise AssertionError(f"megakernel ({name}) h bit-exact on {n_exact}/{steps} steps")
    if not max(layer_rels) <= MEGA_LAYER_REL:
        raise AssertionError(f"megakernel ({name}) one-layer h rel_l2 {max(layer_rels)} > "
                             f"{MEGA_LAYER_REL}")
    b_ms, b_by = mega_step_bound(pack, dcfg, [pos0 + steps], kv)
    log(f"  K1 ({name}) bound at pos {pos0 + steps}: {b_ms:.4f} ms ({b_by})")
    return max_err, ms, plain, b_ms, b_by


def graphed_ms(step, tok, pos: int, n: int = 50) -> tuple[float, float]:
    """K1's step as the decode loops run it (a GraphStep over `step`: one
    eager step, the capture, then replays) from position pos: (device ms per
    replayed step between CUDA events, the host's enqueue ms per replayed
    step: the run() calls of 20 steps on the host clock, before the
    synchronize). Writes cache rows pos .. pos + n + 22."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk

    run = mk.GraphStep(step)
    buf = torch.zeros(n + 24, dtype=torch.int32, device="cuda")
    buf[0] = tok[0]
    run(buf, 1, pos)       # eager, then the capture
    run(buf, 2, pos + 1)   # the first replay
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(3, n + 3):
        run(buf, i, pos + i - 1)
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n + 3, n + 23):
        run(buf, i, pos + i - 1)
    enqueue = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, enqueue


def eager_ms(step, tok, pos: int, n: int = 50) -> tuple[float, float]:
    """The same for eager steps (one call of the step per token, every
    launch from the host): device ms per step between CUDA events and the
    host's enqueue ms per step. Writes cache rows pos .. pos + n + 21."""
    import torch

    out = torch.zeros(n + 23, dtype=torch.int32, device="cuda")
    out[0] = tok[0]
    step(out[0:1], pos, out[1:2])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(2, n + 2):
        step(out[i - 1:i], pos + i - 1, out[i:i + 1])
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n + 2, n + 22):
        step(out[i - 1:i], pos + i - 1, out[i:i + 1])
    enqueue = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, enqueue


GRAPH_STEPS = 64   # eager and graphed steps compared bit for bit


def phase_mega_graph(cfg, dec, kv: str = "bf16", S: int = 1664,
                     pos0: int = MEGA_TIMED_POS - GRAPH_STEPS):
    """K1 replayed from a CUDA graph (GraphStep, as generate_greedy, the
    streaming chunks and a lone server request run it) against eager steps,
    on the CLI default mode (int8 pack, bf16 cache): GRAPH_STEPS free-running
    steps from the same token and the same filled cache, each way; tokens
    and h torch.equal on every step and the caches torch.equal after the
    last. Then ms/step and the host's enqueue per step, eager and graphed,
    each with programmatic dependent launch on (the default) and off. ->
    {(graphed, pdl): (ms, enqueue)}."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk

    dcfg, pack = cfg.decoder, dec["mega"]
    name = mode_name(pack, kv)
    a = _filled_cache(dcfg, S, pos0, torch.Generator(device="cuda").manual_seed(3), kv)
    b = _clone(a)
    eager = mk.DecodeStep(pack, dcfg, *a)
    graphed = mk.GraphStep(mk.DecodeStep(pack, dcfg, *b))
    toks = torch.zeros(GRAPH_STEPS + 1, dtype=torch.int32, device="cuda")
    buf = torch.zeros(GRAPH_STEPS + 1, dtype=torch.int32, device="cuda")
    toks[0] = buf[0] = 1000
    n_equal = 0
    for i in range(1, GRAPH_STEPS + 1):
        eager(toks[i - 1:i], pos0 + i - 1, toks[i:i + 1])
        graphed(buf, i, pos0 + i - 1)
        torch.cuda.synchronize()
        if not (torch.equal(toks[i], buf[i]) and torch.equal(eager.h, graphed.step.h)):
            raise AssertionError(f"K1 ({name}) graphed step {i} (pos {pos0 + i - 1}) "
                                 f"differs from the eager step")
        n_equal += 1
    if not all(x is None or torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"K1 ({name}): the graphed steps' caches differ from the "
                             f"eager steps' after {GRAPH_STEPS} steps")
    times = {}
    for pdl in (True, False):
        for graph in (False, True):
            st = mk.DecodeStep(pack, dcfg, *_clone(a), pdl=pdl)
            pos = pos0 + GRAPH_STEPS
            times[(graph, pdl)] = (graphed_ms if graph else eager_ms)(st, toks[-1:], pos)
            del st
    log(f"phase K1 graph ({name}) S={S} pos={pos0}..{pos0 + GRAPH_STEPS - 1}: "
        f"{n_equal}/{GRAPH_STEPS} graphed steps torch.equal to eager (token, h), caches "
        f"torch.equal after the last; {mk.step_kernels(dcfg.n_layers)} kernels a step")
    for (graph, pdl), (ms, enq) in sorted(times.items()):
        log(f"  {'graphed' if graph else 'eager  '} pdl={'on ' if pdl else 'off'}: "
            f"{ms:.4f} ms/step, host enqueue {enq:.4f} ms/step")
    return times


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
        g1 = [None if t is None else t[l:l + 1] for t in got]
        r1 = [None if t is None else t[l:l + 1] for t in ref]
        step = mk.DecodeStep(pk, cfg1, *g1)
        step(x, pos, out)
        rh = mk.mega_decode_step_ref(pk, cfg1, x, pos, *r1)[1]
        torch.cuda.synchronize()
        if _bad_cache_layers(g1, r1, pos):
            raise AssertionError(f"layer {l} on the same input: fresh cache "
                                 f"rows differ")
        rels.append(_rel(step.h, rh))
        x = rh.to(torch.bfloat16).contiguous()
    return rels


def _filled_pool(dcfg, S: int, pos, seed: int, kv: str = "int8"):
    """(k, v, k_s, v_s) [B, L, S, ...]: slab b's rows < pos[b] filled as
    _filled_cache fills them (bf16: k_s = v_s = None)."""
    import torch

    slabs = [_filled_cache(dcfg, S, int(p),
                           torch.Generator(device="cuda").manual_seed(seed + b), kv)
             for b, p in enumerate(pos)]
    return [None if slabs[0][i] is None else torch.stack([s[i] for s in slabs])
            for i in range(4)]


def _slab(ts, b: int):
    """Slab b of a pool (k, v, k_s, v_s), None kept."""
    return [None if t is None else t[b] for t in ts]


def _spread(B: int):
    """B cache positions spread over 64 .. 1600."""
    import numpy as np

    return [int(p) for p in np.linspace(64, 1600, B).round()]


MEGA_BATCH_ROWS = (8, 13, 16)   # K3's checked batches: one 8-row MMA n-tile, two (13: ragged)
MEGA_BATCH_TIMED = (1, 4, 8, 16)
PLAIN_STEPS = {8: 4, 13: 2, 16: 2}   # K3 vs its plain version: steps at each B


def k3_vs_k1(dcfg, pack, kv: str, B: int):
    """(a) K3 at B rows at spread positions over a pool of MEGA_BATCH_S
    rows: MEGA_BATCH_STEPS teacher-forced steps against K1 (its step over the
    same cache type) run on each row's slab copy: tokens, h and every layer's
    fresh K/V rows (and scales) torch.equal on every step and row, and the
    whole pool equal after the last. -> (pool, step, toks, pos0)."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb

    S = MEGA_BATCH_S
    pos0 = _spread(B)
    pool = _filled_pool(dcfg, S, pos0, 100, kv)
    singles = [_clone(_slab(pool, b)) for b in range(B)]
    step = mb.BatchDecodeStep(pack, dcfg, *pool)
    k1 = [mk.DecodeStep(pack, dcfg, *singles[b]) for b in range(B)]
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    toks = torch.arange(1000, 1000 + B, dtype=torch.int32, device="cuda")
    live = [i for i, t in enumerate(pool) if t is not None]
    n_equal = 0
    for i in range(MEGA_BATCH_STEPS):
        pos = [p + i for p in pos0]
        step(toks, torch.tensor(pos, dtype=torch.int32, device="cuda"), out,
             (min(pos), max(pos)))
        for b in range(B):
            k1[b](toks[b:b + 1], pos[b], one)
            same = (torch.equal(out[b:b + 1], one) and torch.equal(step.h[b:b + 1], k1[b].h)
                    and all(torch.equal(pool[j][b, :, pos[b]], singles[b][j][:, pos[b]])
                            for j in live))
            if not same:
                raise AssertionError(f"K3 row {b} of {B} differs from K1 on its slab at "
                                     f"step {i} (pos {pos[b]})")
            n_equal += 1
        toks = out.clone()
    # no stray writes: every row of every slab, not only the fresh ones
    for b in range(B):
        for j in live:
            if not torch.equal(pool[j][b], singles[b][j]):
                raise AssertionError(f"K3 cache pool tensor {j}, slab {b} of {B} differs "
                                     f"from K1's slab after {MEGA_BATCH_STEPS} steps")
    log(f"phase K3 ({mode_name(pack, kv)}) vs K1 S={S} B={B} pos={pos0[0]}..{pos0[-1]}: "
        f"{n_equal}/{MEGA_BATCH_STEPS * B} row-steps torch.equal (token, h, "
        f"fresh K/V rows{' and scales' if kv == 'int8' else ''} of all "
        f"{dcfg.n_layers} layers); whole cache pool torch.equal to the K1 slabs "
        f"after the last step")
    return pool, step, toks, pos0


def k3_vs_plain(dcfg, pack, kv: str, pool, step, toks, pos0, steps: int):
    """(b) K3 against its plain version, teacher-forced on the plain
    version's tokens, from the positions after (a): near-tie tokens, h rel
    L2 <= MEGA_H_REL on every row-step and bit-exact on at least half, the
    cache rule. -> (max_abs_err, plain ms of one step of all B rows)."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb

    B = len(pos0)
    ref = _clone(pool)
    live = [i for i, t in enumerate(pool) if t is not None]
    out = torch.empty(B, dtype=torch.int32, device="cuda")
    rels, mism, worst_gap, max_err = [], 0, 0.0, 0.0
    for i in range(steps):
        pos = [p + MEGA_BATCH_STEPS + i for p in pos0]
        step(toks, torch.tensor(pos, dtype=torch.int32, device="cuda"), out,
             (min(pos), max(pos)))
        nxt = []
        for b in range(B):
            rb = _slab(ref, b)
            rt, rh, logits = mk.mega_decode_step_ref(
                pack, dcfg, toks[b:b + 1], pos[b], *rb, return_logits=True)
            torch.cuda.synchronize()
            max_err = max(max_err, float((step.h[b] - rh[0]).abs().max()))
            rels.append(_rel(step.h[b:b + 1], rh))
            got_t, want_t = int(out[b]), int(rt[0])
            if got_t != want_t:
                mism += 1
                worst_gap = max(worst_gap, float(logits[want_t] - logits[got_t]))
            bad = _bad_cache_layers(_slab(pool, b), rb, pos[b])
            if bad and (rels[-1] == 0.0 or bad[0] == 0):
                raise AssertionError(f"K3 vs plain, B={B} step {i} row {b}: fresh cache "
                                     f"rows of layers {bad} differ")
            for j in live:
                ref[j][b, :, pos[b]] = pool[j][b, :, pos[b]]
            nxt.append(rt)
        toks = torch.cat(nxt)
    n_exact = sum(r == 0.0 for r in rels)
    log(f"phase K3 ({mode_name(pack, kv)}) vs plain, {steps} steps x {B} rows: "
        f"max_abs_err(h)={max_err:.3e} rel_l2(h) max {max(rels):.4f}, bit-exact on "
        f"{n_exact}/{len(rels)}; token mismatches {mism} (worst plain logit gap "
        f"{worst_gap:.4f})")
    if worst_gap > NEAR_TIE_TOL:
        raise AssertionError(f"K3 tokens disagree with the plain version at B={B}")
    if not max(rels) <= MEGA_H_REL or 2 * n_exact < len(rels):
        raise AssertionError(f"K3 h vs plain at B={B}: rel_l2 max {max(rels)}, "
                             f"{n_exact}/{len(rels)} bit-exact")
    last = [p + MEGA_BATCH_STEPS + steps for p in pos0]
    plain = cuda_ms(lambda: mb.mega_decode_step_batch_ref(pack, dcfg, toks, last, *ref), 1,
                    warmup=0) if B == 8 else None
    return max_err, plain


def phase_mega_batch(dcfg, pack, kv: str = "int8", trace: bool = False):
    """K3 at full width over an int8 or (kv="bf16") a bf16 cache, S =
    MEGA_BATCH_S, at MEGA_BATCH_ROWS rows (one and two MMA n-tiles) at spread
    positions: (a) k3_vs_k1 and (b) k3_vs_plain at each B. (c) eager and
    graphed ms/step at B = 1, 4, 8, 16 with the bound at each
    (profile_decode.profile_batch), with `trace` torch.profiler's split by
    kernel at B = 8, K1's eager ms/step beside them. -> (max_abs_err, eager
    ms at B 8, plain ms at B 8, bound ms at B 8, bound_by, the readings)."""
    import torch

    from qwen3_asr_tpu_torch import profile_decode as pd
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    name = mode_name(pack, kv)
    max_err, plain = 0.0, None
    for B in MEGA_BATCH_ROWS:
        pool, step, toks, pos0 = k3_vs_k1(dcfg, pack, kv, B)
        err, p = k3_vs_plain(dcfg, pack, kv, pool, step, toks, pos0, PLAIN_STEPS[B])
        max_err, plain = max(max_err, err), p if p is not None else plain
        del pool, step

    # (c) times at the spread positions
    gen = torch.Generator(device="cuda").manual_seed(200)
    rows = {B: pd.profile_batch(pack, dcfg, B, kv, gen=gen, trace=trace and B == 8)
            for B in MEGA_BATCH_TIMED}
    single = _filled_cache(dcfg, MEGA_BATCH_S, pd.spread_positions(1)[0], gen, kv)
    k1 = mk.DecodeStep(pack, dcfg, *single)
    one = torch.empty(1, dtype=torch.int32, device="cuda")
    tok = torch.full((1,), 1000, dtype=torch.int32, device="cuda")
    k1_ms = cuda_ms(lambda: k1(tok, pd.spread_positions(1)[0], one), 20)
    r8 = rows[8]
    log(f"phase K3 ({name}) times (ms/step, eager / graphed / bound): " + ", ".join(
        f"B={B} {r['eager_ms']:.4f} / {r['graphed_ms']:.4f} / {r['bound_ms']:.4f}"
        for B, r in rows.items())
        + f"; K1 eager {k1_ms:.4f} (B x K1 at B=8: {8 * k1_ms:.4f}); plain at B=8 "
        f"{plain:.4f}")
    if trace:
        log(f"  B=8 profiled: device {r8['device_ms']:.4f} ms/step, busy {r8['busy']:.3f}, "
            f"{r8['launches_per_step']:.1f} launches/step: " + "; ".join(
                f"{k[:40]} {us:.1f} us ({r8['kernels_n'][k]:.0f})"
                for k, us in sorted(r8["kernels_us"].items(), key=lambda kv: -kv[1])))
    readings = {"eager_ms": {B: r["eager_ms"] for B, r in rows.items()},
                "graphed_ms": {B: r["graphed_ms"] for B, r in rows.items()},
                "bound_ms_at": {B: r["bound_ms"] for B, r in rows.items()},
                "b8_trace_us": r8["kernels_us"], "b8_busy": r8["busy"],
                "k1_eager_ms": k1_ms}
    return max_err, r8["eager_ms"], plain, r8["bound_ms"], r8["bound_by"], readings


PRODUCT_ROWS = (8, 16)


def phase_k3_product(dcfg, pack):
    """One of K3's products alone (`batch_product_i8`) on the int8 pack, at
    the QKV (layer 0) and the lm head's shapes for B = 8 and 16, on random
    codes: its int32 sums torch.equal to `torch._int_mm`'s (rows padded as
    `q8_matmul.int8_matmul` pads them), both timed from a CUDA graph of 20
    calls beside the bound. -> {(shape, B): (ms, library ms, bound ms,
    bound_by)}."""
    import torch

    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb
    from qwen3_asr_tpu_torch.ops.q8_matmul import int8_matmul

    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for shape, w in (("QKV", pack["qkv_q"][0]), ("lm head", pack["head_q"])):
        K, N = w.shape
        for B in PRODUCT_ROWS:
            xq = torch.randint(-127, 128, (B, K), generator=g, device="cuda",
                               dtype=torch.int32).to(torch.int8)
            got, want = mb.batch_product_i8(xq, w), int8_matmul(xq, w)
            if not torch.equal(got, want):
                raise AssertionError(f"K3 product alone ({shape}, B={B}): int32 sums "
                                     f"differ from torch._int_mm's")
            scratch = mb.product_scratch(B, K, N, "cuda")
            xp = torch.nn.functional.pad(xq, (0, 0, 0, max(32, -(-B // 8) * 8) - B))
            ms = graph_ms(lambda: mb.batch_product_i8(xq, w, scratch))
            lib = graph_ms(lambda: torch._int_mm(xp, w))
            b_ms, b_by = bound(K * N + B * K + 4 * B * N, 2.0 * B * K * N, INT8_OPS)
            out[(shape, B)] = (ms, lib, b_ms, b_by)
            log(f"phase K3 product alone ({shape}: K {K}, N {N}), B={B}: int32 sums "
                f"torch.equal to torch._int_mm's; {ms:.4f} ms (graph), _int_mm "
                f"{lib:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    return out


def twin_steps(asr, samples, tokens, mel_bucket: int = 0) -> list:
    """The twins (the plain versions of K1, K2 and K4-K7) teacher-forced on
    `tokens` for one request: -> per token i, (h, logits): h the hidden
    state before the final norm that predicts token i (the prompt's last
    row for i = 0, else the step consuming tokens[i - 1]; bf16 from the
    prefill and the per-layer step, f32 from K1's twin, as the sampled
    path hands them to its head), logits the
    greedy path's (the decode pack's own head on a pack, else lm_logits(h)).
    mel_bucket > 0: the frontend is the bucketed batched one (the serving
    path), with the flash kernel's plain version in its encoder too. A tree
    without a decode pack runs the per-layer decode step with the twins of
    K4-K7."""
    import torch

    from qwen3_asr_tpu_torch.audio.mel import mel_device
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models import encoder as emod
    from qwen3_asr_tpu_torch.models import generate as gen
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
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
        kv = gen.kv_dtype(dec, asr.cache_dtype)
        cache = dmod.init_kv_cache(dcfg, S, "cuda", torch.int8 if kv == gen.INT4_KV else kv)
        h0 = dmod.embed_with_audio(dec, torch.tensor(prompt, device="cuda"), feats,
                                   n_audio, off)
        h = dmod.decoder_forward(dec, dcfg, h0, cache, P)[P - 1]
        steps = [(h, dmod.lm_logits(dec, dcfg, h))]
        kvs = gen.mega_caches(dcfg, cache, kv) if mega else None
        for i in range(1, len(tokens)):
            pos = P + i - 1
            t = torch.tensor([tokens[i - 1]], dtype=torch.int32, device="cuda")
            if mega:
                _, h, lg = mk.mega_decode_step_ref(dec["mega"], dcfg, t, pos, *kvs,
                                                   return_logits=True)
                steps.append((h.reshape(-1), lg))
            else:
                h = gen.decode_hidden(dec, dcfg, cache, t, pos)
                steps.append((h, dmod.lm_logits(dec, dcfg, h)))
    return steps


def check_tokens_vs_twins(asr, samples, tokens, mel_bucket: int = 0):
    """The kernel path's tokens on one request vs the twins, teacher-forced
    on those tokens (twin_steps): each is the twin's argmax or within
    NEAR_TIE_TOL."""
    import numpy as np
    import torch

    gaps = []
    for (_, lg), tok in zip(twin_steps(asr, samples, tokens, mel_bucket), tokens):
        best = int(torch.argmax(lg))
        gaps.append(float(lg[best] - lg[tok]))
    agree = sum(g == 0.0 for g in gaps)
    dec = asr.params["decoder"]
    what = mode_name(dec["mega"], asr.kv_cache) if "mega" in dec else asr.quantize or "dense"
    log(f"{what} path vs twins "
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
    0's Q8_0 weights of the model, at each T of Ts; at each T every row
    torch.equal to the one-row launch on that row alone, and two launches
    on the same input equal (the body sums each output in one order, whatever
    T is). -> {(name, T): (max_abs_err, kernel ms, twin ms, bound ms,
    bound_by)}."""
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
                 lambda v: q8.q8_matmul(v, wo["q8:q"], wo["q8:s"]),
                 lambda v: q8.q8_matmul_ref(v, wo["q8:q"], wo["q8:s"])),
                ("K6 q8_norm_matmul (QKV)", wqkv, x,
                 lambda v: q8.q8_norm_matmul(v, wqkv, nw, eps),
                 lambda v: q8.q8_norm_matmul_ref(v, wqkv["q8:q"], wqkv["q8:s"], nw, eps)),
                ("K6 q8_norm_matmul (lm head)", head, x,
                 lambda v: q8.q8_norm_matmul(v, head, nw, eps),
                 lambda v: q8.q8_norm_matmul_ref(v, head["q8:q"], head["q8:s"], nw, eps))):
            n_in, n_out = w["q8:q"].shape
            bf16 = q8.deq_bf16_for(n_out)
            nbytes = _q8_bytes(n_in, n_out) + 2 * T * n_in + 4 * T * n_out
            cases.append((name, xx, fn, ref, bf16, nbytes, 2.0 * T * n_in * n_out))
        n_w = H * 2 * FF + FF * H
        cases.append(("K7 q8_mlp", x, lambda v: q8.q8_mlp(v, gu, dn, nw, eps, FF),
                      lambda v: q8.q8_mlp_ref(v, gu["q8:q"], gu["q8:s"], dn["q8:q"],
                                              dn["q8:s"], nw, eps, FF),
                      True, _q8_bytes(H, 2 * FF) + _q8_bytes(FF, H) + 2 * T * H + 4 * T * H,
                      2.0 * T * n_w))
        for name, xx, fn, ref, bf16, nbytes, ops in cases:
            got, again, want = fn(xx), fn(xx), ref(xx)
            rows = [fn(xx[t:t + 1]) for t in range(T)]
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float((got - want).norm() / want.norm())
            scale = float(want.abs().max())
            n_equal = sum(torch.equal(got[t:t + 1], r) for t, r in enumerate(rows))
            ms = graph_ms(lambda: fn(xx))
            call = cuda_ms(lambda: fn(xx), 20)
            plain = cuda_ms(lambda: ref(xx), 3, warmup=1)
            b_ms, b_by = bound(nbytes, ops, BF16_FLOPS if bf16 else F32_FLOPS)
            log(f"phase {name} T={T} ({'bf16' if bf16 else 'f32'} dequant): "
                f"max_abs_err={err:.3e} rel_l2 {rel:.3e} (max |ref| {scale:.3f}); rows "
                f"torch.equal to one-row launches {n_equal}/{T}, two launches equal "
                f"{torch.equal(got, again)}; kernel {ms:.4f} ms (graph; {call:.4f} ms a call "
                f"from the host), twin {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
                f"{nbytes / 1e6:.3f} MB)")
            if not rel <= (Q8_BF16_REL if bf16 else Q8_F32_REL) or (
                    bf16 and not err <= Q8_BF16_ATOL * scale):
                raise AssertionError(f"{name} T={T} disagrees with its twin")
            if n_equal != T or not torch.equal(got, again):
                raise AssertionError(f"{name} T={T}: {T - n_equal} rows differ from their "
                                     f"one-row launches, or two launches differ")
            out[(name, T)] = (err, ms, plain, b_ms, b_by)
    return out


# K4's graphed ms before its one-launch redesign (PERF.md §5, K4's readings:
# the two-kernel tree's phase_decode_attention(_batch), which had no store,
# read by chip_compare.py on an H100 80GB HBM3 at 700 W): one row at offset
# 1,248 on each cache, B 8 at offsets 64..1,600 on each cache. Logged beside
# this run's, never in the kernels line (it holds this run's measurements).
K4_PARENT_MS = {("bf16", 1248): 0.0174, ("int8", 1248): 0.0182, "bf16": 0.0377,
                "int8": 0.0357}
# the one-row store checks' offsets: chunk edges (64-row chunks), the timed
# row and the last row of S 1,664
K4_STORE_OFFSETS = (0, 1, 63, 64, 65, 1248, 1663)


def phase_decode_attention(dcfg, pos: int, S: int) -> dict:
    """K4 against its twin with a bf16 and an int8 cache of S rows, at
    offset = pos and at offset 0; two launches with the same bits; one
    kernel a call (the kernel nodes of a call captured in a CUDA graph); the
    in-kernel store torch.equal to store_kv_rows (what _store runs) at
    K4_STORE_OFFSETS. Timed as the decode step calls it, store on (into a
    copy of the caches; every call rewrites the same row), the store-off
    time logged beside it; the bound counts the stored row's bytes. ->
    {(cache, offset): (max_abs_err, kernel ms, twin ms, bound ms,
    bound_by)}."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

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
            again = da.decode_attention(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"decode attention ({cache}, offset {off}): two "
                                     f"launches give other bits")
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ratio = max(float(((a - b).abs() / (DA_ATOL * b.abs().max() + DA_RTOL * b.abs()))
                              .max()) for a, b in zip(got, want))
            # the decoder's call: store on, into a copy of the caches
            tk, tv = k.clone(), v.clone()
            tkw = dict(kw, store=True, **({"k_scale": kw["k_scale"].clone(),
                                           "v_scale": kw["v_scale"].clone()}
                                          if cache == "int8" else {}))
            targs = (qkv, tk, tv, qn, kn, off, off)
            ms = graph_ms(lambda: da.decode_attention(*targs, **tkw))
            no_store = graph_ms(lambda: da.decode_attention(*args, **kw))
            call = cuda_ms(lambda: da.decode_attention(*targs, **tkw), 50)
            plain = cuda_ms(lambda: da.decode_attention_ref(*targs, **tkw), 5)
            n_kernels = kernels_a_call(lambda: da.decode_attention(*targs, **tkw))
            # the live rows read, qkv read, the f32 outputs and the stored row written
            nbytes = (off + 1) * row_bytes + 2 * qkv.numel() + 4 * (NH + 2 * NKV) * D
            b_ms, b_by = bound(nbytes, 4.0 * NH * D * (off + 1), F32_FLOPS)
            parent = K4_PARENT_MS.get((cache, off))
            log(f"phase K4 decode_attention {cache} cache S={S} offset=pos={off}: "
                f"max_abs_err={err:.3e} worst |err| / (atol + rtol |ref|) {ratio:.4f}; "
                f"kernel with its store {ms:.4f} ms (graph; store off {no_store:.4f} ms; "
                f"parent, store off, "
                f"{'not measured' if parent is None else f'{parent:.4f} ms'}; "
                f"{call:.4f} ms a call from the host), {n_kernels} kernel(s) a call, twin "
                f"with its store {plain:.4f} ms; bound {b_ms:.5f} ms ({b_by}, "
                f"{nbytes / 1e6:.3f} MB)")
            if not ratio <= 1.0:
                raise AssertionError(f"decode attention ({cache}, offset {off}) "
                                     f"disagrees with its twin")
            if n_kernels != 1:
                raise AssertionError(f"decode attention ({cache}, offset {off}): "
                                     f"{n_kernels} kernels a call, not 1")
            out[(cache, off)] = (err, ms, plain, b_ms, b_by)
        caches = {"k": k, "v": v, **({"k_s": kw["k_scale"], "v_s": kw["v_scale"]}
                                     if cache == "int8" else {})}
        one = {n: x for n, x in kw.items() if n not in ("k_scale", "v_scale")}
        for off in K4_STORE_OFFSETS:
            da.check_store(
                f"K4 {cache} store at offset {off}",
                lambda c, st: da.decode_attention(qkv, c["k"], c["v"], qn, kn, off, off,
                                                  **one, k_scale=c.get("k_s"),
                                                  v_scale=c.get("v_s"), store=st),
                caches, off)
        log(f"  K4 {cache}: the in-kernel store torch.equal to store_kv_rows (_store) at "
            f"offsets {K4_STORE_OFFSETS}")
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
    Dense weights launch no K5-K7. Its L prefill layers run eager."""
    steps = max_tokens - 1
    want = dict(no_launches(), flash=L, decode_attention=L * steps,
                **prefill_want(1, False, L))
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
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR
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
        asr.transcribe(pcm(5, 1), tparams(4))   # warm-up
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
        r = asr.transcribe(pcm(seconds), tparams(max_tokens))
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
    from qwen3_asr_tpu_torch import microbench_stream as ms
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops import flash_attention as fa
    from qwen3_asr_tpu_torch.ops import megakernel as mk
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mb
    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops import prefill_fused as pf
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    return {"flash": fa.flash_attention_batch, "mega": mk.mega_decode_step_i8,
            "mega_bf16": mk.mega_decode_step, "mega_i4": mk.mega_decode_step_i4,
            "mega_batch": mb.mega_decode_step_batch,
            "mega_batch_bf16": mb.mega_decode_step_batch_bf16,
            "decode_attention": da.decode_attention,
            "decode_attention_batch": da.decode_attention_batch, "q8_matmul": q8.q8_matmul,
            "q8_norm_matmul": q8.q8_norm_matmul, "q8_mlp": q8.q8_mlp,
            "mb_read": ms.stream_read, "mb_read_ring": ms.stream_read_ring,
            "mb_gemv": ms.stream_gemv, "mb_gemv_i4": ms.stream_gemv_i4,
            "mb_unpack": ms.unpack_probe,
            **{n: getattr(pf, n) for n in PREFILL_PASSES},
            **{n: getattr(moe, n) for n in MOE_WRAPPERS}}


# The int8pc prefill's fused passes (`ops/prefill_fused.py`), by the names
# the launch counts and `models/decoder.py` use.
PREFILL_PASSES = ("norm_quant_rows", "qkv_epilogue", "residual_norm_quant", "swiglu_quant")


# The MoE path's wrappers (`ops/moe.py`): the prefill's router and grouped
# products and the residual pass after them, and the MoE decode step.
MOE_WRAPPERS = ("route", "moe_gate_up", "moe_down", "moe_combine", "moe_decode_step")


# Every checked window of a path: (label, the decode pack's weight bits or
# None, launch counts). The kernels line sums them.
WINDOWS: list = []


def window(label: str, wbits, got: dict) -> dict:
    WINDOWS.append((label, wbits, dict(got)))
    return got


def launches_of_label(label: str, key: str) -> int:
    """A wrapper's launches in the checked window named `label`."""
    return sum(c[key] for lab, _, c in WINDOWS if lab == label)


def launches_of(key: str, wbits=None) -> int:
    """A wrapper's launches over the checked windows (those of one pack's
    weight bits when wbits is given)."""
    return sum(c[key] for _, w, c in WINDOWS if wbits is None or w == wbits)


def launch_counts() -> dict:
    """Launch counts of the kernels' wrappers."""
    return {k: w.launches for k, w in _wrappers().items()}


def counts() -> dict:
    """launch_counts() and the decoder prefill's layers by path
    (`_prefill_layers.fused_layers` / `.eager_layers`)."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    return dict(launch_counts(), fused_layers=dmod._prefill_layers.fused_layers,
                eager_layers=dmod._prefill_layers.eager_layers)


def reset_counts() -> None:
    from qwen3_asr_tpu_torch.models import decoder as dmod

    for w in _wrappers().values():
        w.launches = 0
    dmod._prefill_layers.fused_layers = dmod._prefill_layers.eager_layers = 0


def no_launches() -> dict:
    return {k: 0 for k in counts()}


def prefill_want(n: int, fused: bool, L: int = 28) -> dict:
    """What n decoder prefills of L layers add to a window's counts: on
    int8pc leaves (fused) n * L fused layers and each pass's launches a
    prefill (norm_quant_rows L + 1: layer 0's norm and every attention
    output; qkv_epilogue L; residual_norm_quant 2 L; swiglu_quant L);
    otherwise n * L eager layers and no pass."""
    if not fused:
        return {"eager_layers": n * L}
    return {"fused_layers": n * L, "norm_quant_rows": (L + 1) * n, "qkv_epilogue": L * n,
            "residual_norm_quant": 2 * L * n, "swiglu_quant": L * n}


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    HBM_BPS and the operations over `peak`, and which of the two it is."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class twins:
    """Inside the block the decoder and encoder call the plain twins of K2,
    K4-K7 and the int8pc prefill's fused passes on the card (the Q8_0
    wrappers' own path above 256 rows is no kernel and stays). Leaving it
    raises if any launch count moved: a call site left unpatched would
    compare a kernel with itself."""

    def __enter__(self):
        from qwen3_asr_tpu_torch.models import decoder as dmod
        from qwen3_asr_tpu_torch.models import encoder as emod
        from qwen3_asr_tpu_torch.ops import decode_attention as da
        from qwen3_asr_tpu_torch.ops import flash_attention as fa
        from qwen3_asr_tpu_torch.ops import prefill_fused as pf
        from qwen3_asr_tpu_torch.ops import q8_matmul as q8

        self._counts = launch_counts()
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
                       (dmod, "decode_attention_batch", dmod.decode_attention_batch),
                       (dmod, "q8_norm_matmul", k6), (dmod, "q8_mlp", k7),
                       (q8, "q8_matmul", k5)]
        dmod.flash_attention_batch = emod.flash_attention_batch = fa.flash_attention_ref
        dmod.decode_attention = da.decode_attention_ref
        dmod.decode_attention_batch = (
            lambda qkv, kc, vc, qn, kn, offs, pos, bound, **kw:
            da.decode_attention_batch_ref(qkv, kc, vc, qn, kn, offs, pos, **kw))
        dmod.q8_norm_matmul, dmod.q8_mlp, q8.q8_matmul = t6, t7, t5
        for name in PREFILL_PASSES:
            self._saved.append((dmod, name, getattr(dmod, name)))
            setattr(dmod, name, getattr(pf, name + "_ref"))
        return self

    def __exit__(self, exc_type, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        if exc_type is None and launch_counts() != self._counts:
            raise AssertionError(f"a kernel launched inside twins(): launch counts "
                                 f"{self._counts} -> {launch_counts()}")
        return False


def encoder_calls(groups) -> int:
    """Batched encoder calls of the bucketed frontend (one per distinct
    mel bucket of each admitted or transcribed group)."""
    from qwen3_asr_tpu_torch.audio.mel import num_mel_frames

    b = ENGINE_KW["mel_bucket"]
    return sum(len({-(-num_mel_frames(len(x)) // b) for x in g}) for g in groups)


def check_launches(what: str, got: dict, k3_steps: int, groups) -> None:
    """K3 = k3_steps; K2 = 28 per batched prefill (one per group) + 18 per
    batched encoder call, each prefill fused (the int4 model's int8pc
    leaves); no K1 on these paths."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig

    cfg = ASRModelConfig()
    want = dict(no_launches(), flash=cfg.decoder.n_layers * len(groups)
                + cfg.encoder.n_layers * encoder_calls(groups), mega_batch=k3_steps,
                **prefill_want(len(groups), True, cfg.decoder.n_layers))
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


AUTO_REQUESTS = ((5, 64), (92, 323), (92, 1))   # (seconds, max_tokens)


def eos_off(asr):
    """Fixed-length decode, as the bench runs it: EOS outside the argmax range."""
    asr.cfg = dataclasses.replace(
        asr.cfg, decoder=dataclasses.replace(asr.cfg.decoder, eos_token_id=-1))
    return asr


def like(asr, kv_cache: str):
    """The same model with another KV cache (the weights are shared)."""
    import copy

    other = copy.copy(asr)
    other.kv_cache = kv_cache
    return other


def phase_int4_bf16(asr4):
    """`--quantize int4` without `--kv-int8`: K1's int4 pack over a bf16
    cache on one 5 s / 64-token request (a window of its own), its tokens
    against the twins."""
    import torch

    asr = like(asr4, "bf16")
    L = asr.cfg.decoder.n_layers
    asr.transcribe(pcm(5, 1), tparams(4))   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r = asr.transcribe(pcm(5), tparams(64))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = window("int4 weights, bf16 KV, 5 s", 4, counts())
    want = dict(no_launches(), flash=L, mega_bf16=63, **prefill_want(1, True, L))
    log(f"request int4 weights, bf16 KV, 5 s: {ms:.1f} ms, {len(r.tokens)} tokens; "
        f"launches {got}")
    if got != want or len(r.tokens) != 64:
        raise AssertionError(f"int4 / bf16 KV request: launches {got} != {want} or "
                             f"{len(r.tokens)} tokens")
    check_tokens_vs_twins(asr, pcm(5), r.tokens[:16])


def timed_request(asr, seconds: float, max_tokens: int, **kw):
    """One request with the counts reset just before it: -> (result, host
    ms, launch counts)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r = asr.transcribe(pcm(seconds), tparams(max_tokens, **kw))
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3, counts()


def check_window(what: str, wbits, got: dict, r, max_tokens: int, **want_kw) -> None:
    """A request's window: launch counts as want_kw says (K2 once per
    decoder layer; one prefill, fused on a model with a decode pack of
    wbits, whose leaves are int8pc), max_tokens in-range tokens."""
    from qwen3_asr_tpu_torch.config import DecoderConfig

    window(what, wbits, got)
    L, V = DecoderConfig().n_layers, DecoderConfig().vocab_size
    want = dict(no_launches(), flash=L, **prefill_want(1, wbits is not None, L), **want_kw)
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")
    if not r.success or len(r.tokens) != max_tokens or not all(0 <= t < V for t in r.tokens):
        raise AssertionError(f"{what}: {len(r.tokens)} tokens or one out of range")


def phase_kv_int4(asr4, auto):
    """`Qwen3ASR(quantize=q, kv_cache="int4").transcribe` (`--kv-int4`) for
    q = int4 (the int4 pack), auto and int8pc (both the int8 pack): a 5 s /
    64-token request each, a window of its own (K2 once per decoder layer,
    K1's int4 entry once per decode step), tokens against the twins; the
    int4 pack also at 92 s / 323 and 92 s / 1, whose difference over 322
    steps is its decode ms/step. -> that ms/step."""
    ms = {}
    for label, base, quantize in (("int4", asr4, "int4"), ("auto", auto, "auto"),
                                  ("int8pc", auto, "int8pc")):
        asr = like(base, "int4")
        asr.quantize = quantize
        wbits = 4 if label == "int4" else 8
        reqs = ((5, 64), (92, 323), (92, 1)) if label == "int4" else ((5, 64),)
        for seconds, max_tokens in reqs:
            r, t, got = timed_request(asr, seconds, max_tokens)
            what = f"quantize={quantize!r}, int4 KV, {seconds} s / {max_tokens}"
            log(f"request {what}: {t:.1f} ms, {len(r.tokens)} tokens; launches {got}")
            check_window(what, wbits, got, r, max_tokens, mega_i4=max_tokens - 1)
            ms[(label, seconds, max_tokens)] = t
            if seconds == 5:
                check_tokens_vs_twins(asr, pcm(5), r.tokens[:16])
    per_step = (ms[("int4", 92, 323)] - ms[("int4", 92, 1)]) / 322
    log(f"int4 weights + int4 KV decode: {per_step:.4f} ms/step (92 s request, fused)")
    return per_step


def phase_streaming(asr4, auto):
    """The streaming path on the card (`--progress`, the server's lone SSE
    streams): a progress callback set, so transcribe() takes the staged path
    with generate_greedy_streaming (8 steps per host read). For the auto
    path (int8 pack, bf16 KV) and for int4 weights with the int4 cache: a
    5 s / 64-token request, a window of its own, whose tokens equal
    transcribe's without the callback and which calls it once per token;
    then 92 s / 323 and 92 s / 1 with and without the callback (the staged
    path's generate_greedy), whose differences over 322 steps are the two
    decode ms/step. -> {label: (streaming ms/step, generate_greedy
    ms/step)}."""
    out = {}
    for label, asr, wbits, key in (("auto", auto, 8, "mega_bf16"),
                                   ("int4 + int4 KV", like(asr4, "int4"), 4, "mega_i4")):
        base = asr.transcribe(pcm(5), tparams(64)).tokens
        calls = []
        asr.set_progress_callback(lambda i, total: calls.append(i))
        try:
            r, t, got = timed_request(asr, 5, 64)
            what = f"streaming ({label}) 5 s / 64"
            log(f"request {what}: {t:.1f} ms, {len(r.tokens)} tokens, {len(calls)} "
                f"callbacks; launches {got}")
            check_window(what, wbits, got, r, 64, **{key: 63})
            if r.tokens != base or calls != list(range(1, 65)):
                raise AssertionError(f"{what}: tokens differ from transcribe's or "
                                     f"{len(calls)} callbacks")
            ms = {(True, n): timed_request(asr, 92, n, fused=False)[1] for n in (323, 1)}
        finally:
            asr.set_progress_callback(None)
        ms.update({(False, n): timed_request(asr, 92, n, fused=False)[1] for n in (323, 1)})
        out[label] = tuple((ms[(s, 323)] - ms[(s, 1)]) / 322 for s in (True, False))
        log(f"  {label}: streaming decode {out[label][0]:.4f} ms/step, generate_greedy "
            f"(staged) {out[label][1]:.4f} ms/step (92 s / 323 minus 92 s / 1)")
    return out


def phase_server_int4(auto):
    """`qwen3-asr-cuda-serve --kv-cache int4` (closed batches) behind
    serve_http on 127.0.0.1, port 0: a lone POST /v1/transcribe (transcribe
    over the int4 cache: K1's int4 entry) and a lone SSE stream on
    /v1/audio/transcriptions (outside any pool: the streaming path over the
    int4 cache), each a window of its own; tokens and text equal
    transcribe's on the same audio, the SSE deltas add up to its done
    text."""
    import json
    import threading
    import urllib.request

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.serve import ASRServer, serve_http
    from qwen3_asr_tpu_torch.text.prompt import extract_transcript

    asr = like(auto, "int4")
    params = TranscribeParams(max_tokens=ENGINE_TOKENS, mel_bucket=ENGINE_KW["mel_bucket"],
                              print_timing=False)
    server = ASRServer(asr, params, max_batch=4, max_wait_ms=5)
    httpd = serve_http(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    boundary = "chipsmokeboundary"
    a_lone, a_sse = pcm(15, 40), pcm(30, 41)
    sse_body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"a.wav\"\r\n\r\n").encode() + wav_bytes(a_sse) + (
        f"\r\n--{boundary}\r\nContent-Disposition: form-data; name=\"stream\""
        f"\r\n\r\ntrue\r\n--{boundary}--\r\n").encode()
    L, EL = asr.cfg.decoder.n_layers, asr.cfg.encoder.n_layers
    replies = {}
    try:
        for what, path, body, ctype, audio in (
                ("lone request", "/v1/transcribe", wav_bytes(a_lone), "audio/wav", a_lone),
                ("lone SSE stream", "/v1/audio/transcriptions", sse_body,
                 f"multipart/form-data; boundary={boundary}", a_sse)):
            reset_counts()
            t0 = time.perf_counter()
            req = urllib.request.Request(base + path, data=body,
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=600) as rsp:
                replies[what] = (rsp.status, rsp.read(), (time.perf_counter() - t0) * 1e3)
            got = window(f"server --kv-cache int4, {what}", 8, counts())
            want = dict(no_launches(), flash=L + EL * encoder_calls([[audio]]),
                        mega_i4=ENGINE_TOKENS - 1, **prefill_want(1, True, L))
            log(f"phase server --kv-cache int4, {what}: code {replies[what][0]}, "
                f"{replies[what][2]:.1f} ms; launches {got} (want {want})")
            if replies[what][0] != 200 or got != want:
                raise AssertionError(f"server int4 {what}: code {replies[what][0]}, "
                                     f"launches {got}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    ref_lone, ref_sse = asr.transcribe(a_lone, params), asr.transcribe(a_sse, params)
    if json.loads(replies["lone request"][1])["text"] != ref_lone.text:
        raise AssertionError("server int4 lone request: text differs from transcribe's")
    data = [line[6:] for line in replies["lone SSE stream"][1].decode().split("\n")
            if line.startswith("data: ")]
    events = [json.loads(d) for d in data[:-1]]
    deltas = [e["delta"] for e in events if e["type"] == "transcript.text.delta"]
    if (data[-1] != "[DONE]" or events[-1]["type"] != "transcript.text.done"
            or events[-1]["text"] != extract_transcript(ref_sse.text)
            or "".join(deltas) != events[-1]["text"]):
        raise AssertionError("server int4 SSE stream: events differ from transcribe's text")
    check_request("server int4 lone request", ref_lone.tokens, asr.cfg.decoder.vocab_size)
    log(f"  SSE: {len(deltas)} deltas adding up to the done text; lone and SSE text "
        f"equal transcribe's")


def phase_auto():
    """The CLI's default configuration (`qwen3-asr-cuda-cli -f x.wav`):
    `Qwen3ASR(quantize="auto")` on dense random weights (seed 0) resolves to
    int8pc, the int8 pack and a bf16 cache; EOS off. The 5 s / 64, 92 s / 323
    and 92 s / 1 requests on the fused path (the CLI's default) and then on
    the staged one, each a window: K2 once per decoder layer, K1's bf16 entry
    max_tokens - 1 times. Decode ms per step is (92 s / 323 - 92 s / 1) / 322
    on each path; the staged path's tokens must equal the fused path's, and
    the fused 5 s tokens hold against the twins. -> (the model, fused and
    staged decode ms/step, the 92 s request's stage times)."""
    import torch

    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.ops.megakernel import weight_bits
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR
    from qwen3_asr_tpu_torch.runtime.params import assert_on_device

    t0 = time.perf_counter()
    asr = Qwen3ASR(quantize="auto", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    torch.cuda.synchronize()
    log(f"load_random, quantize='auto': {time.perf_counter() - t0:.1f} s")
    eos_off(asr)
    dec, L = asr.params["decoder"], asr.cfg.decoder.n_layers
    if weight_bits(dec["mega"]) != 8 or asr.cache_dtype != torch.bfloat16:
        raise AssertionError("quantize='auto' did not resolve to the int8 pack "
                             "and the bf16 cache")
    assert_on_device(asr.params, "cuda")
    asr.transcribe(pcm(5, 1), tparams(8))   # warm-up
    tokens, ms, stages = {}, {}, None
    for fused in (True, False):
        path = "fused" if fused else "staged"
        for seconds, max_tokens in AUTO_REQUESTS:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            r = asr.transcribe(pcm(seconds), tparams(max_tokens, fused=fused))
            torch.cuda.synchronize()
            ms[(fused, seconds, max_tokens)] = (time.perf_counter() - t0) * 1e3
            got = window(f"auto {path} {seconds} s / {max_tokens}", 8, counts())
            want = dict(no_launches(), flash=L, mega_bf16=max_tokens - 1,
                        **prefill_want(1, True, L))
            log(f"request quantize='auto' ({path}) {seconds} s: "
                f"{ms[(fused, seconds, max_tokens)]:.1f} ms, {len(r.tokens)} tokens "
                f"(max {max_tokens}); launches {got}")
            if got != want:
                raise AssertionError(f"auto {path} launch counts {got} != {want}")
            if not r.success or len(r.tokens) != max_tokens:
                raise AssertionError(f"auto {path} {seconds} s: {len(r.tokens)} tokens")
            tokens[(fused, seconds, max_tokens)] = r.tokens
            if not fused and max_tokens == 323:
                stages = (r.t_mel_ms, r.t_encode_ms, r.t_decode_ms, r.t_total_ms)
    per_step = {f: (ms[(f, 92, 323)] - ms[(f, 92, 1)]) / 322 for f in (True, False)}
    log(f"auto decode ms/step: fused {per_step[True]:.4f}, staged {per_step[False]:.4f}; "
        f"staged 92 s stages (mel, encode, decode, total ms): "
        + ", ".join(f"{t:.1f}" for t in stages))
    for seconds, max_tokens in AUTO_REQUESTS:
        if tokens[(True, seconds, max_tokens)] != tokens[(False, seconds, max_tokens)]:
            raise AssertionError(f"auto {seconds} s: staged tokens differ from fused")
    log("  staged tokens equal fused tokens on every request")
    check_tokens_vs_twins(asr, pcm(5), tokens[(True, 5, 64)][:16])
    return asr, per_step, stages


# The int8pc prefill's fused passes (phase_prefill_passes) at the main
# path's rows: prompts of 5, 55 and 92+ s (T 80, 730, 1,280) and a server
# batch of six 30 s prompts (B·P 6 x 405), on layer 0 with norm weights 1 +
# N(0, 0.25) (the random model's are ones, under which a dropped rounding of
# x * r before the product with w shows nothing). A pass without a norm must
# equal its twin (torch's own ops on the card) bit for bit. A pass with a
# norm sums its f32 squares in another order than torch's reduction, which
# can round a bf16 value the other way: at most PF_MOVED of its int8 codes
# (of its bf16 values for q and k) may differ, codes by one. An H100 reads
# at most 1.1e-5; a kernel with one of the chain's bf16 roundings skipped
# moves 4e-2 or more (tests/test_torch_chip_faults.py). The stack (phase_prefill_fused): a layer alone
# on the eager chain's input to it, h rel L2 <= PF_LAYER_REL and at most
# PF_LAYER_K_MOVED of its k rows' values moved (a moved code moves a whole
# row of its product: 1.1e-3 read); the whole stack against the eager chain
# from one prompt, the first greedy token equal.
PF_SHAPES = ((1, 80), (1, 730), (1, 1280), (6, 405))
PF_MOVED = 1e-4
PF_LAYER_REL = 1e-2
PF_LAYER_K_MOVED = 5e-3


def _pf_codes(got, want, N: int) -> tuple[float, int]:
    """(share of moved codes in rows < N, largest code difference); the
    padding rows must stay zero."""
    if got[0][N:].any():
        raise AssertionError("a fused pass wrote a padding row of its codes")
    d = (got[0][:N].int() - want[0][:N].int()).abs()
    return float((d != 0).float().mean()), int(d.max())


def _pf_bf16(got, want) -> tuple[float, int]:
    """(share of moved bf16 values, largest difference in bf16 steps)."""
    import torch

    d = (got.contiguous().view(torch.int16).int() - want.contiguous().view(torch.int16).int())
    return float((d != 0).float().mean()), int(d.abs().max())


def phase_prefill_passes(auto) -> dict:
    """The four fused passes of the int8pc prefill (`ops/prefill_fused.py`)
    against their twins at PF_SHAPES, on the twins' layer 0 (embedded random
    tokens, norm weights 1 + N(0, 0.25)): moved codes and values, kernel and
    twin ms from a CUDA graph of 20 calls, the bound (bytes). -> {pass name:
    {shape: (moved share, ms, plain_ms, bound_ms, bound_by)}}."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops import prefill_fused as pf
    from qwen3_asr_tpu_torch.ops.q8_matmul import int8_matmul

    dec, dcfg = auto.params["decoder"], auto.cfg.decoder
    lay, eps = dec["layers"], dcfg.rms_norm_eps
    NH, NKV, D, F, H = (dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim,
                        dcfg.intermediate_size, dcfg.hidden_size)
    dq, cols = NH * D, (NH + 2 * NKV) * D
    g = torch.Generator(device="cuda").manual_seed(17)
    nw = {n: (1 + 0.5 * torch.randn(lay[n][0].shape, generator=g, device="cuda"))
          .to(torch.bfloat16) for n in ("attn_norm", "ffn_norm", "q_norm", "k_norm")}
    inv_freq = dmod.rope_inv_freq(D, float(dcfg.rope_theta), torch.device("cuda"))
    passes: dict = {}

    for B, P in PF_SHAPES:
        N, shape = B * P, f"B{B}xP{P}"
        tok = torch.randint(0, dcfg.vocab_size, (B, P), generator=g, device="cuda")
        x = dec["token_embd"][tok].reshape(N, H)
        valid = torch.tensor([P - 7 * b for b in range(B)], dtype=torch.int32, device="cuda")
        w = {n: dmod._leaf(lay, n, 0) for n in dmod._PC_MATRICES}

        def bufs(n):
            return pf.codes_buffer(N, n, "cuda"), torch.empty(N, 1, device="cuda")

        # the twins' layer 0: each pass's inputs
        xq, sx = bufs(H)
        pf.norm_quant_rows_ref(x, nw["attn_norm"], eps, xq, sx)
        acc_qkv = int8_matmul(xq, w["wqkv"]["i8pc:q"])
        qkv_args = (acc_qkv, sx, w["wqkv"]["i8pc:s"], nw["q_norm"], nw["k_norm"],
                    P, NH, NKV, D, eps, inv_freq)
        q, k, v = pf.qkv_epilogue_ref(*qkv_args)
        attn = dmod.flash_attention_batch(q, k, v, valid, causal=True,
                                          scale=1.0 / float(D) ** 0.5).reshape(N, dq)
        aq, asx = bufs(dq)
        pf.norm_quant_rows_ref(attn, None, eps, aq, asx)
        acc_wo = int8_matmul(aq, w["wo"]["i8pc:q"])
        gq, gsx = bufs(H)
        pf.residual_norm_quant_ref(x, acc_wo, asx, w["wo"]["i8pc:s"], nw["ffn_norm"], eps,
                                   gq, gsx)
        acc_gu = int8_matmul(gq, w["w_gate_up"]["i8pc:q"])

        cases = {
            "norm_quant_rows (RMSNorm, QKV input)": (
                lambda f, c, s: f(x, nw["attn_norm"], eps, c, s), H,
                2 * N * H + 2 * H + N * H + 4 * N, True),
            "norm_quant_rows (attention output, Wo input)": (
                lambda f, c, s: f(attn, None, eps, c, s), dq, 2 * N * dq + N * dq + 4 * N, False),
            "residual_norm_quant (Wo, FFN norm)": (
                lambda f, c, s: f(x, acc_wo, asx, w["wo"]["i8pc:s"], nw["ffn_norm"], eps,
                                  c, s), H, 2 * N * H + 4 * N * H + 6 * H + 4 * N
                + 2 * N * H + N * H + 4 * N, True),
            "swiglu_quant": (
                lambda f, c, s: f(acc_gu, gsx, w["w_gate_up"]["i8pc:s"], F, c, s), F,
                8 * N * F + 8 * F + 4 * N + N * F + 4 * N, False),
        }
        kern = {"norm_quant_rows": (pf.norm_quant_rows, pf.norm_quant_rows_ref),
                "residual_norm_quant": (pf.residual_norm_quant, pf.residual_norm_quant_ref),
                "swiglu_quant": (pf.swiglu_quant, pf.swiglu_quant_ref)}
        for name, (call, n, nbytes, normed) in cases.items():
            fn, ref = kern[name.split()[0]]
            got, want = bufs(n), bufs(n)
            rg, rw = call(fn, *got), call(ref, *want)
            if rg is not None and not torch.equal(rg, rw):
                raise AssertionError(f"{name} {shape}: the residual differs from the twin's")
            moved, dmax = _pf_codes(got, want, N)
            sx_rel = float(((got[1] - want[1]).abs() / want[1]).max())
            exact = moved == 0.0 and torch.equal(got[1], want[1])
            log(f"  {name} {shape}: codes moved {moved:.3e}, largest difference {dmax}, "
                f"scales rel {sx_rel:.2e}" + ("" if normed else " (must be bit-equal)")
                + f"; bound {PF_MOVED:g}")
            if (not normed and not exact) or moved > PF_MOVED or dmax > 1:
                raise AssertionError(f"{name} {shape}: codes moved {moved}, difference {dmax}")
            c, s = bufs(n)
            ms = graph_ms(lambda: call(fn, c, s))
            plain = graph_ms(lambda: call(ref, c, s))
            passes.setdefault(name, {})[shape] = (moved, ms, plain,
                                                  *bound(nbytes, 0.0, INT8_OPS))
        qg, kg, vg = pf.qkv_epilogue(*qkv_args)
        if not torch.equal(vg, v):
            raise AssertionError(f"qkv_epilogue {shape}: v differs from the twin's")
        (qm, qd), (km, kd) = _pf_bf16(qg, q), _pf_bf16(kg, k)
        log(f"  qkv_epilogue {shape}: q moved {qm:.3e} (largest {qd} bf16 steps), "
            f"k moved {km:.3e} ({kd}), v bit-equal; bound {PF_MOVED:g}")
        if max(qm, km) > PF_MOVED:
            raise AssertionError(f"qkv_epilogue {shape}: q / k moved {qm} / {km}")
        ms = graph_ms(lambda: pf.qkv_epilogue(*qkv_args))
        plain = graph_ms(lambda: pf.qkv_epilogue_ref(*qkv_args))
        nbytes = 4 * N * cols + 4 * cols + 4 * N + 4 * D + 2 * D + 2 * N * cols
        passes.setdefault("qkv_epilogue", {})[shape] = (max(qm, km), ms, plain,
                                                        *bound(nbytes, 0.0, INT8_OPS))
    return passes


def phase_prefill_fused(auto) -> dict:
    """The int8pc prefill's fused chain: its passes (phase_prefill_passes),
    then `_prefill_layers` fused against the eager chain at PF_SHAPES (ms a
    prefill, device operations a prefill and a layer from torch.profiler),
    each layer alone on the eager input, the stack's first token, no
    host-device sync in the fused stack, and 28 fused layers a CLI request.
    -> {"passes": phase_prefill_passes's, "prefill": {...}}."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod

    passes = phase_prefill_passes(auto)
    dec, dcfg = auto.params["decoder"], auto.cfg.decoder
    lay, L = dec["layers"], dcfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(18)
    prefill: dict = {}

    def eager(fn):
        saved = dmod._fusable
        dmod._fusable = lambda *a: False
        try:
            return fn()
        finally:
            dmod._fusable = saved

    for B, P in PF_SHAPES:
        shape = f"B{B}xP{P}"
        tok = torch.randint(0, dcfg.vocab_size, (B, P), generator=g, device="cuda")
        h = dec["token_embd"][tok]
        valid = torch.tensor([P - 7 * b for b in range(B)], dtype=torch.int32, device="cuda")

        def stack():
            return dmod._prefill_layers(dec, dcfg, h, valid, lambda *a: None)

        fused_ms, eager_ms = cuda_ms(stack, 5), eager(lambda: cuda_ms(stack, 5))
        _, kf = profiled(stack)
        _, ke = eager(lambda: profiled(stack))
        nf, ne = sum(c for _, c, _ in kf), sum(c for _, c, _ in ke)
        prefill[shape] = {"fused_ms": fused_ms, "eager_ms": eager_ms,
                          "fused_device_ops": nf, "eager_device_ops": ne}
        log(f"  prefill {shape}: fused {fused_ms:.3f} ms, eager {eager_ms:.3f} ms; device "
            f"operations a prefill (torch.profiler) fused {nf} ({nf / L:.1f} a layer), "
            f"eager {ne} ({ne / L:.1f} a layer); fused busiest: "
            + "; ".join(f"{nm[:40]} {t:.3f} ms x{c}" for t, c, nm in kf[:6]))
        if nf > 12 * L + 8:
            raise AssertionError(f"prefill {shape}: {nf} device operations")

    # each layer alone on the eager chain's input, and the stack from one prompt
    B, P = 1, 730
    tok = torch.randint(0, dcfg.vocab_size, (B, P), generator=g, device="cuda")
    h0 = dec["token_embd"][tok]
    valid = torch.tensor([P], dtype=torch.int32, device="cuda")
    cfg1 = dataclasses.replace(dcfg, n_layers=1)
    xin, rels, kmoved = h0, [], []
    for l in range(L):
        d1 = dict(dec, layers={n: ({a: b[l:l + 1] for a, b in t.items()}
                                   if isinstance(t, dict) else t[l:l + 1])
                               for n, t in lay.items()})
        rows, erows = [], []
        got = dmod._prefill_layers(d1, cfg1, xin, valid, lambda _, k_, v_: rows.append(k_))
        ref = eager(lambda: dmod._prefill_layers(d1, cfg1, xin, valid,
                                                 lambda _, k_, v_: erows.append(k_)))
        rels.append(_rel(got, ref))
        kmoved.append(_pf_bf16(rows[0], erows[0])[0])
        xin = ref
    log(f"  each layer alone on the eager input ({P} rows): h rel L2 max {max(rels):.3e} "
        f"(layer {rels.index(max(rels))}; bound {PF_LAYER_REL}), k rows moved "
        f"{max(kmoved):.3e} at most (bound {PF_LAYER_K_MOVED})")
    if max(rels) > PF_LAYER_REL or max(kmoved) > PF_LAYER_K_MOVED:
        raise AssertionError(f"fused layer rel L2 {max(rels):.3e}, k rows moved "
                             f"{max(kmoved):.3e}")

    def first(h_):
        lg = dmod.lm_logits(dec, dcfg, h_[0, P - 1])
        return int(torch.argmax(lg)), lg

    hf = dmod._prefill_layers(dec, dcfg, h0, valid, lambda *a: None)
    he = eager(lambda: dmod._prefill_layers(dec, dcfg, h0, valid, lambda *a: None))
    (tf, _), (te, lge) = first(hf), first(he)
    diff = float((hf.float() - he.float()).abs().max())
    log(f"  stack of {L} layers, fused vs eager ({P} rows): h rel L2 {_rel(hf, he):.3e}, "
        f"largest difference {diff:.4f}; first token {tf} / {te} (gap "
        f"{float(lge[te] - lge[tf]):.4f})")
    if tf != te:
        raise AssertionError(f"the fused stack's first token {tf} != the eager {te}")
    prefill["stack"] = {"h_rel": _rel(hf, he), "h_max_abs": diff, "layer_rel_max": max(rels),
                        "k_moved_max": max(kmoved)}

    # no host-device sync in the fused stack; 28 fused layers a CLI request
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dmod._prefill_layers(dec, dcfg, h0, valid, lambda *a: None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("  the fused stack ran under set_sync_debug_mode('error')")
    fused0, eager0 = dmod._prefill_layers.fused_layers, dmod._prefill_layers.eager_layers
    auto.transcribe(pcm(5), tparams(8))
    got = (dmod._prefill_layers.fused_layers - fused0, dmod._prefill_layers.eager_layers - eager0)
    log(f"  a 5 s CLI request: fused / eager layers {got}")
    if got != (L, 0):
        raise AssertionError(f"a CLI request's prefill layers (fused, eager) {got}")
    return {"passes": passes, "prefill": prefill}


def phase_server_default(auto):
    """`qwen3-asr-cuda-serve`'s default configuration: quantize auto (the
    int8 pack) with the int8 cache, closed batches. Four requests submitted
    at once form one closed batch (K3 on the int8 pack) and a lone request
    goes to `transcribe` (K1, int8 weights and int8 KV), one window; their
    tokens must equal transcribe_batch's and transcribe's on the same audio
    (a second window). -> the closed batch's decode ms/step: (the reference
    transcribe_batch - the same batch with one token) / (ENGINE_TOKENS - 1),
    host clock."""
    import torch

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.serve import ASRServer

    asr = like(auto, "int8")
    params = TranscribeParams(max_tokens=ENGINE_TOKENS, mel_bucket=ENGINE_KW["mel_bucket"],
                              print_timing=False)
    audio = [pcm(sec, 30 + i) for i, sec in enumerate((5, 15, 30, 92))]
    server = ASRServer(asr, params, max_batch=4, max_wait_ms=5000)
    batches = []
    run = server._run_transcribe

    def recording(batch):
        batches.append(len(batch))
        return run(batch)

    server._run_transcribe = recording
    torch.cuda.synchronize()
    reset_counts()
    try:
        t0 = time.perf_counter()
        futs = [server.submit(a) for a in audio]
        got_batch = [f.result(timeout=600) for f in futs]
        lone = server.submit(audio[0]).result(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        server.close()
    served = window("server default (closed batch + lone)", 8, counts())
    groups = [audio, audio[:1]]
    want = dict(no_launches(), mega_batch=ENGINE_TOKENS - 1, mega=ENGINE_TOKENS - 1,
                flash=asr.cfg.decoder.n_layers * len(groups)
                + asr.cfg.encoder.n_layers * encoder_calls(groups),
                **prefill_want(len(groups), True, asr.cfg.decoder.n_layers))
    log(f"phase server default (auto, int8 KV, closed batches): batches {batches}; "
        f"wall {wall * 1e3:.1f} ms; launches {served} (want {want})")
    if batches != [4] or served != want:
        raise AssertionError(f"server default: batches {batches}, launches {served}")
    reset_counts()
    t0 = time.perf_counter()
    ref = asr.transcribe_batch(audio, params)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    ref_lone = asr.transcribe(audio[0], params)
    torch.cuda.synchronize()
    window("server default reference", 8, counts())
    t0 = time.perf_counter()
    asr.transcribe_batch(audio, dataclasses.replace(params, max_tokens=1))
    torch.cuda.synchronize()
    step_ms = (batch_ms - (time.perf_counter() - t0) * 1e3) / (ENGINE_TOKENS - 1)
    log(f"  the closed batch of 4 (transcribe_batch, auto + int8 KV): decode "
        f"{step_ms:.4f} ms/step")
    V = asr.cfg.decoder.vocab_size
    for k, (r, w) in enumerate(zip(got_batch + [lone], ref + [ref_lone])):
        check_request(f"server request {k}", r.tokens, V)
        if r.tokens != w.tokens:
            raise AssertionError(f"server request {k} differs from transcribe_batch / "
                                 f"transcribe")
    log("  server tokens equal transcribe_batch's (batch of 4) and transcribe's (lone)")
    check_tokens_vs_twins(asr, audio[0], lone.tokens[:16], mel_bucket=ENGINE_KW["mel_bucket"])
    return step_ms


MB_ITERS = 10


def phase_microbench():
    """K9-K11 (`python -m qwen3_asr_tpu_torch.microbench_stream`): every mode
    against its twin on the default stream (284 x [1024, 2048] int8 chunks,
    0.596 GB), then the timed passes as a window (one warm-up and MB_ITERS
    passes a mode); `torch.Tensor.sum` over the same bytes beside `read`.
    -> {mode: (max_abs_err, ms, plain ms, bound ms, bound_by)}, the library
    ms of read."""
    import torch

    from qwen3_asr_tpu_torch import microbench_stream as ms

    d = ms.make_data(284, 2048, "cuda")
    errs = ms.check_modes(d)
    torch.cuda.synchronize()
    reset_counts()
    res = ms.time_modes(d, MB_ITERS)
    got = window("microbench", None, counts())
    n = 1 + MB_ITERS
    want = dict(no_launches(), mb_read=n, mb_read_ring=n, mb_gemv=3 * n, mb_gemv_i4=n,
                mb_unpack=n)
    if got != want:
        raise AssertionError(f"microbench launch counts {got} != {want}")
    lib = cuda_ms(lambda: d["w"].sum(dtype=torch.int64), 5)
    out = {}
    for mode in ms.MODES:
        ref = ms.runner(mode, d)[1]
        plain = cuda_ms(ref, 1, warmup=0)
        peak = BF16_FLOPS if mode == "bf16_m8" else INT8_OPS
        b_ms, b_by = bound(ms.mode_bytes(mode, d), ms.mode_ops(mode, d), peak)
        r = res[mode]
        out[mode] = (errs[mode], r["ms"], plain, b_ms, b_by)
        log(f"phase microbench {mode}: {r['ms']:.4f} ms/pass, {r['gb_s']:.1f} GB/s "
            f"({100 * r['hbm_share']:.1f}% of 3.35 TB/s), max_abs_err vs twin "
            f"{errs[mode]:.3g}; twin {plain:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    log(f"  torch.Tensor.sum over the same {d['w'].numel() / 1e9:.4f} GB: {lib:.4f} ms")
    del d
    return out, res, lib


def phase_probe() -> tuple[float, float, float, float]:
    """K8, the capability probe (y = 2 x over 8 x 128 f32, exact), and its
    plain version `torch.mul`, each timed from a CUDA graph of 20 launches;
    its bound is its bytes (x read, y written). -> (max abs err, ms, plain
    ms, bound ms)."""
    import ctypes

    import torch

    from qwen3_asr_tpu_torch.ops.build import kernel
    from qwen3_asr_tpu_torch.ops.support import stream_ptr

    fn = kernel("qw_probe", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)

    def probe():
        fn(x.data_ptr(), y.data_ptr(), x.numel(), stream_ptr(dev))

    probe()
    torch.cuda.synchronize()
    err = float((y - 2 * x).abs().max())
    if not torch.equal(y, 2 * x):
        raise AssertionError("the probe kernel's y != 2 x")
    ms = graph_ms(probe)
    y2 = torch.empty_like(x)
    plain = graph_ms(lambda: torch.mul(x, 2, out=y2))
    b_ms, _ = bound(2.0 * x.numel() * 4, x.numel(), F32_FLOPS)
    log(f"phase probe (K8): {ms:.4f} ms a launch, torch.mul {plain:.4f} ms, bound "
        f"{b_ms:.6f} ms (bytes: {2 * x.numel() * 4} B)")
    return err, ms, plain, b_ms


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


# ---------------------------------------------------------------------------
# the forced aligner (Qwen3-ForcedAligner-0.6B) and the combined mode
# ---------------------------------------------------------------------------

ALIGN_SECONDS, ALIGN_WORDS = 92, 183      # bench_align.py's workload
ALIGN_BATCH = ((92, 183), (60, 120), (30, 60), (5, 10))   # (seconds, words)
ALIGN_BUCKET = 500      # mel frames: the server's bucket
ALIGN_REPS = 5          # timed runs per stage (after one warm-up)
# One layer of the NAR pass on the twin's input to it: the kernel's hidden
# state over all P rows (padding rows included, which attend only keys <
# n_valid) within ALIGN_LAYER_REL relative L2 of the twin's. K2 and its
# twin round each attention output to bf16 once; where one rounds the other
# way the layer's output moves by ~1e-3.
ALIGN_LAYER_REL = 1e-2
# The windowed encoder's attention (block-diagonal, plain PyTorch) against
# full attention with a block-diagonal mask built here, on the same q, k, v:
# the same f32 math in another order, then one bf16 rounding, so each row's
# rel L2 stays within ALIGN_ATTN_REL (a row whose window is wrong reads
# other keys and moves by far more).
ALIGN_ATTN_REL = 2e-2


def align_pcm(seconds: float, seed: int = 0):
    """bench_align.py's audio: a 440 Hz tone plus noise, int16."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    return (a * 32767.0).clip(-32768, 32767).astype(np.int16)


def align_text(n_words: int) -> str:
    return " ".join(f"word{i:03d}" for i in range(n_words))


def byte_vocab(V: int, word_tokens: bool = False) -> list[str]:
    """256 byte tokens, then fillers: "[PADi]" (decoded to nothing), or
    with word_tokens " t<i>" (each decodes to a word, so a random model's
    transcript has words to align)."""
    from qwen3_asr_tpu_torch.text.bpe import _byte_to_unicode

    table = _byte_to_unicode()
    space = table[ord(" ")]
    return [table[b] for b in range(256)] + [
        f"{space}t{i}" if word_tokens else f"[PAD{i}]" for i in range(256, V)]


def load_aligner(quantize):
    """Qwen3-ForcedAligner-0.6B at full width and depth, random weights from
    seed 0 on the card, bench_align.py's byte vocabulary."""
    import torch

    from qwen3_asr_tpu_torch.config import AlignerModelConfig
    from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
    from qwen3_asr_tpu_torch.runtime.params import assert_on_device

    t0 = time.perf_counter()
    cfg = AlignerModelConfig()
    fa = ForcedAligner(quantize=quantize, device="cuda")
    fa.load_random(cfg, seed=0, vocab=byte_vocab(cfg.decoder.vocab_size))
    torch.cuda.synchronize()
    assert_on_device(fa.params, "cuda")
    dec = fa.params["decoder"]
    if "lm_head_pc" in dec or "lm_head_q8" in dec or "mega" in dec:
        raise AssertionError("the aligner carries an lm head copy or a decode pack")
    log(f"aligner load_random (quantize={quantize!r}): {time.perf_counter() - t0:.1f} s")
    return fa


def check_words(what: str, r, n_words: int, seconds: float) -> None:
    """183 words (or n_words), start <= end <= the audio's length, starts
    non-decreasing."""
    if not r.success or len(r.words) != n_words:
        raise AssertionError(f"{what}: success={r.success}, {len(r.words)} words")
    starts = [w.start for w in r.words]
    if any(not 0.0 <= w.start <= w.end <= seconds for w in r.words) or \
            starts != sorted(starts):
        raise AssertionError(f"{what}: timestamps out of order or past {seconds} s")


def ts_logits(fa, prompts, feats, n_audio):
    """The classify head's f32 logits at each prompt's <ts> rows, from one
    batched NAR pass."""
    from qwen3_asr_tpu_torch.models.decoder import classify_logits

    h = fa.nar_pass(prompts, feats, n_audio)
    ts = fa.cfg.timestamp_token_id
    return [classify_logits(fa.params["decoder"], fa.cfg.decoder,
                            h[b, [i for i, t in enumerate(p) if t == ts]])
            for b, p in enumerate(prompts)]


def near_tie_mismatches(got, want, gap) -> tuple[int, int]:
    """(classes that differ, how many of those are NOT near ties): a class
    may differ only where the reference's top-two gap < NEAR_TIE_TOL."""
    bad = got != want
    return int(bad.sum()), int((bad & (gap >= NEAR_TIE_TOL)).sum())


def top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


def random_mel(fa, n_frames: int, n_bucket: int = 0):
    """A seeded standard-normal mel [128, n_bucket or n_frames] on the
    aligner's device, frames past n_frames zero: unlike the tone, its
    encoder rows differ from one another, so a window that reads the wrong
    rows shows."""
    import torch

    g = torch.Generator(device=fa.device.type).manual_seed(n_frames)
    mel = torch.randn(128, n_bucket or n_frames, generator=g, device=fa.device)
    mel[:, n_frames:] = 0
    return mel


def check_window_attention(fa, mel, n_frames: int, bucket: int) -> float:
    """The encoder's windowed attention against full attention under a
    block-diagonal mask built here (windows of 13 rows per 100-frame chunk
    of n_window_infer; keys past n_audio masked): in every layer the window
    the encoder passes must be that one, and on the encoder's own q, k, v
    and on standard-normal ones of the same shape (whose rows differ, so
    attention over the wrong keys moves a row by about its own size) each
    real row's rel L2 must stay within ALIGN_ATTN_REL. -> the worst row's."""
    import torch

    from qwen3_asr_tpu_torch.models import encoder as emod
    from qwen3_asr_tpu_torch.ops.attention import mha_attention

    ecfg = fa.cfg.encoder
    window = 13 * (ecfg.n_window_infer // ecfg.chunk_size)
    calls, run = [], emod.block_diagonal_attention_batch

    def recording(q, k, v, w, scale, n_valid=None):
        out = run(q, k, v, w, scale, n_valid)
        calls.append((q, k, v, w, scale, n_valid, out))
        return out

    emod.block_diagonal_attention_batch = recording
    try:
        fa.encode(mel, n_frames, bucket)
    finally:
        emod.block_diagonal_attention_batch = run
    if len(calls) != ecfg.n_layers:
        raise AssertionError(f"windowed attention ran {len(calls)} times, not "
                             f"{ecfg.n_layers}")
    g = torch.Generator(device=mel.device.type).manual_seed(bucket)
    worst = 0.0
    for q, k, v, w, scale, n_valid, out in calls:
        if w != window:
            raise AssertionError(f"the encoder's attention window is {w} rows, not {window}")
        rq, rk, rv = (torch.randn(q.shape, generator=g, device=q.device).to(q.dtype)
                      for _ in range(3))
        B, T = q.shape[:2]
        seg = torch.arange(T, device=q.device) // window
        for qq, kk, vv, oo in ((q, k, v, out), (rq, rk, rv, run(rq, rk, rv, w, scale, n_valid))):
            for b in range(B):
                n = T if n_valid is None else int(n_valid[b])
                mask = (seg[:, None] == seg[None, :]) & (torch.arange(T, device=q.device) < n)
                ref = mha_attention(qq[b], kk[b], vv[b], mask, scale)[:n].float().flatten(1)
                err = (oo[b, :n].float().flatten(1) - ref).norm(dim=1) / ref.norm(dim=1)
                worst = max(worst, float(err.max()))
    if not worst <= ALIGN_ATTN_REL:
        raise AssertionError(f"windowed attention rel L2 {worst:.3e} > {ALIGN_ATTN_REL} "
                             f"(bucket {bucket})")
    return worst


def phase_nar_layers(fa, prompt, feats, n_audio: int):
    """The NAR pass one layer at a time: each layer with K2 on the twin's
    input to it, against the twins (K2's plain version): rel L2 over the
    prompt's rows, and each padding row's own rel L2 (a padding row attends
    only keys < n_valid, so a kernel that reads padding keys moves the last
    rows most), each within ALIGN_LAYER_REL. -> (per layer the larger of
    the two, the twin's final hidden state [1, P, hidden])."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod

    dec, dcfg = fa.params["decoder"], fa.cfg.decoder
    toks = torch.from_numpy(fa.prompt_tokens([prompt])[0]).to(fa.device)
    x = dmod.embed_with_audio(dec, toks, feats, n_audio, 1)[None]
    valid = torch.tensor([len(prompt)], dtype=torch.int32, device=fa.device)
    cfg1 = dataclasses.replace(dcfg, n_layers=1)

    def keep(l, k, v):
        return None

    rels = []
    for l in range(dcfg.n_layers):
        d1 = dict(dec, layers={n: ({a: b[l:l + 1] for a, b in t.items()}
                                   if isinstance(t, dict) else t[l:l + 1])
                               for n, t in dec["layers"].items()})
        got = dmod._prefill_layers(d1, cfg1, x, valid, keep)
        with twins():
            ref = dmod._prefill_layers(d1, cfg1, x, valid, keep)
        n = len(prompt)
        pad = ((got[0, n:].float() - ref[0, n:].float()).norm(dim=1)
               / ref[0, n:].float().norm(dim=1))
        rels.append(max(_rel(got[:, :n], ref[:, :n]), float(pad.max())))
        x = ref
    log(f"  NAR pass per layer on the twin's input, rel L2 over the {len(prompt)} "
        f"prompt rows or of one of the {x.shape[1] - len(prompt)} padding rows "
        f"(the larger): "
        f"max {max(rels):.3e} (layer {rels.index(max(rels))}), "
        + ", ".join(f"{r:.1e}" for r in rels) + f" (bound {ALIGN_LAYER_REL})")
    if not max(rels) <= ALIGN_LAYER_REL:
        raise AssertionError(f"NAR layer rel L2 {max(rels):.3e} > {ALIGN_LAYER_REL}")
    return rels, x


def align_stage_ms(fa, audio, text: str) -> dict:
    """Median ms of ALIGN_REPS staged alignments after a warm-up: mel,
    encode and the NAR classify (the pass, the argmax and the fetch of the
    classes) between CUDA events; the host's prompt and post-processing
    (tokens, LIS repair, pairing) on the host clock; and the whole align
    call, staged and fused, on the host clock."""
    import numpy as np
    import torch

    dur = len(audio) / 16000
    rows = {k: [] for k in ("mel", "encode", "classify", "host", "staged", "fused")}
    for rep in range(ALIGN_REPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        ev[0].record()
        mel, nf = fa.frontend(audio)
        ev[1].record()
        feats, na = fa.encode(mel, nf)
        ev[2].record()
        t0 = time.perf_counter()
        prompt, words = fa.prompt(text, "", nf)
        t_prompt = time.perf_counter() - t0
        pred = fa.classify([prompt], feats[None], [na])[0]
        ev[3].record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fa.words(prompt, pred, words, dur)
        host = (time.perf_counter() - t0 + t_prompt) * 1e3
        t0 = time.perf_counter()
        fa.align(audio, text)
        staged = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        fa.align(audio, text, fused=True)
        fused = (time.perf_counter() - t0) * 1e3
        if rep == 0:
            continue   # warm-up
        for k, t in (("mel", ev[0].elapsed_time(ev[1])), ("encode", ev[1].elapsed_time(ev[2])),
                     ("classify", ev[2].elapsed_time(ev[3])), ("host", host),
                     ("staged", staged), ("fused", fused)):
            rows[k].append(t)
    return {k: float(np.median(v)) for k, v in rows.items()}


def profiled(fn) -> tuple[float, list]:
    """fn() once under torch.profiler: -> (wall ms, the kernels as (self
    device ms, count, name), most device time first; empty when the
    profiler recorded no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0 and "CUDA" in str(getattr(evt, "device_type", "")):
            kernels.append((dev_us / 1e3, evt.count, evt.key))
    return wall, sorted(kernels, reverse=True)


def profile_align(fa, audio, text: str, label: str, top: int = 8) -> None:
    """One staged alignment under torch.profiler (after the warm-ups): the
    wall time, the device's busy time (the kernels' self device time) and
    the kernels with the most device time."""
    wall, kernels = profiled(lambda: fa.align(audio, text))
    if not kernels:
        log(f"  profile ({label}): the profiler recorded no device time")
        return
    busy = sum(k[0] for k in kernels)
    log(f"  profile ({label}, one staged align): wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({busy / wall:.2f}), {sum(k[1] for k in kernels)} kernels; top: "
        + "; ".join(f"{name[:60]} {ms:.3f} ms x{n}" for ms, n, name in kernels[:top]))


def phase_aligner():
    """The forced aligner at Qwen3-ForcedAligner-0.6B's full width and depth
    (24 x d 1,024 windowed encoder, 28-layer decoder at vocab 152,064, 5,000
    classes), random weights from seed 0, on bench_align.py's workload: 92 s
    of tone plus noise and the 183 words word000..word182 (7 byte tokens and
    two <ts> slots each: a prompt of 2,845 rows, bucketed to 2,944).
    - the windowed attention of the encoder against masked full attention,
      exact shape and bucketed;
    - `align` staged, bucketed (mel_bucket 500) and fused, each a window
      (28 K2 launches, none in the encoder): 183 words, start <= end <=
      92.0, starts non-decreasing;
    - every layer of the NAR pass alone on the twin's input, and the classes
      at the <ts> rows against the twins' (K2 -> its plain version): equal
      outside near ties; the three paths' classes likewise;
    - `align_batch` of 4 (92, 60, 30, 5 s with 183, 120, 60, 10 words), one
      window (28 K2 launches): classes equal to four single bucketed calls
      outside near ties;
    - stage times, dense bf16 and quantize="auto" (int8pc layers);
    - `transcribe_and_align` (quantize="auto" for both models): the ASR
      leg's tokens equal `transcribe`'s;
    - `ASRServer(aligner=...)` behind HTTP: /v1/align in multipart and in
      JSON, and the OpenAI route with response_format=srt and with word
      timestamps, each 200 with the aligner's words.
    -> (the K2 launch windows' counts, the stage times per mode)."""
    import torch

    from qwen3_asr_tpu_torch.models import encoder as emod
    from qwen3_asr_tpu_torch.models.e2e import align_fused

    t_phase = time.perf_counter()
    fa = load_aligner(False)
    L = fa.cfg.decoder.n_layers
    audio, text = align_pcm(ALIGN_SECONDS), align_text(ALIGN_WORDS)
    fa.align(audio, text)   # warm-up

    # the windowed encoder: attention against masked full attention, no K2
    mel, nf = fa.frontend(audio)
    reset_counts()
    feats, na = fa.encode(mel, nf)
    torch.cuda.synchronize()
    if counts() != no_launches():
        raise AssertionError(f"the windowed encoder launched a kernel: {counts()}")
    mel_b, nf_b = fa.frontend(audio, ALIGN_BUCKET)
    attn = (check_window_attention(fa, random_mel(fa, nf), nf, 0),
            check_window_attention(fa, random_mel(fa, nf, mel_b.shape[1]), nf, ALIGN_BUCKET))
    log(f"phase aligner: windowed encoder attention vs masked full attention, worst "
        f"row rel L2 {attn[0]:.3e} (exact, T {na}) / {attn[1]:.3e} (bucketed "
        f"{ALIGN_BUCKET} frames; bound {ALIGN_ATTN_REL}); K2 launches in the encoder: 0")

    prompt, _ = fa.prompt(text, "", nf)
    P = fa.prompt_tokens([prompt]).shape[1]
    ts = [i for i, t in enumerate(prompt) if t == fa.cfg.timestamp_token_id]
    log(f"  prompt {len(prompt)} rows (bucket {P}), {len(ts)} <ts> rows, n_audio {na}")
    if len(ts) != 2 * ALIGN_WORDS:
        raise AssertionError(f"{len(ts)} <ts> rows for {ALIGN_WORDS} words")

    # align on its three paths, each a window: 28 K2 launches
    got_launches = {}
    for name, kw in (("staged", {}), ("bucketed", {"mel_bucket": ALIGN_BUCKET}),
                     ("fused", {"fused": True})):
        torch.cuda.synchronize()
        reset_counts()
        r = fa.align(audio, text, **kw)
        torch.cuda.synchronize()
        got = window(f"aligner {name}", None, counts())
        got_launches[name] = got
        want = dict(no_launches(), flash=L, **prefill_want(1, False, L))
        log(f"  align {name}: {len(r.words)} words, first {r.words[0]}, last "
            f"{r.words[-1]}; launches {got}")
        if got != want:
            raise AssertionError(f"aligner {name}: launch counts {got} != {want}")
        check_words(f"aligner {name}", r, ALIGN_WORDS, float(ALIGN_SECONDS))

    # each layer alone on the twin's input; classes against the twins'
    rels, h_twin = phase_nar_layers(fa, prompt, feats, na)
    from qwen3_asr_tpu_torch.models.decoder import classify_logits

    twin_logits = classify_logits(fa.params["decoder"], fa.cfg.decoder, h_twin[0, ts])
    twin_cls, gap = twin_logits.argmax(-1).cpu(), top2_gap(twin_logits)
    k_logits = ts_logits(fa, [prompt], feats[None], [na])[0]
    k_cls = k_logits.argmax(-1).cpu()
    n_bad, n_hard = near_tie_mismatches(k_cls, twin_cls, gap)
    near = int((gap < NEAR_TIE_TOL).sum())
    log(f"  classes at the {len(ts)} <ts> rows vs the twins: {n_bad} differ, "
        f"{n_hard} of them outside near ties; {near} rows are near ties "
        f"(top-two gap < {NEAR_TIE_TOL}); logits max |diff| "
        f"{float((k_logits - twin_logits).abs().max()):.3e}")
    if n_hard:
        raise AssertionError(f"{n_hard} classes differ from the twins' outside near ties")

    # the three paths' classes
    feats_b, na_b = fa.encode(mel_b, nf_b, ALIGN_BUCKET)
    paths = {"staged": k_cls,
             "bucketed": ts_logits(fa, [prompt], feats_b[None], [na_b])[0].argmax(-1).cpu(),
             "fused": torch.from_numpy(align_fused(fa.params, fa.cfg, audio, fa.filters_t,
                                                   prompt)[ts]).long()}
    for name, cls in paths.items():
        n_bad, n_hard = near_tie_mismatches(cls, twin_cls, gap)
        log(f"  {name} classes vs the twins': {n_bad} differ ({n_hard} outside near ties)")
        if n_hard:
            raise AssertionError(f"aligner {name}: classes differ outside near ties")

    # align_batch of four against four single bucketed calls: the raw
    # classes at the <ts> rows (align_batch's own, recorded from its one
    # classify call)
    pairs = [(align_pcm(s, seed=i), align_text(n)) for i, (s, n) in enumerate(ALIGN_BATCH)]
    recorded, classify = [], fa.classify
    fa.classify = lambda *a: recorded.append(classify(*a)) or recorded[-1]
    try:
        torch.cuda.synchronize()
        reset_counts()
        batch = fa.align_batch([a for a, _ in pairs], [t for _, t in pairs],
                               mel_bucket=ALIGN_BUCKET)
        torch.cuda.synchronize()
        got = window("aligner align_batch", None, counts())
    finally:
        del fa.classify
    got_launches["align_batch"] = got
    want = dict(no_launches(), flash=L, **prefill_want(1, False, L))
    log(f"  align_batch of {len(pairs)} ({[s for s, _ in ALIGN_BATCH]} s): launches {got}")
    if got != want or len(recorded) != 1:
        raise AssertionError(f"align_batch launch counts {got} != {want} or "
                             f"{len(recorded)} classify calls")
    for b, ((s, n), r, (a, t)) in enumerate(zip(ALIGN_BATCH, batch, pairs)):
        check_words(f"align_batch {s} s", r, n, float(s))
        mel1, nf1 = fa.frontend(a, ALIGN_BUCKET)
        f1, na1 = fa.encode(mel1, nf1, ALIGN_BUCKET)
        p1, _ = fa.prompt(t, "", nf1)
        ts1 = [i for i, tok in enumerate(p1) if tok == fa.cfg.timestamp_token_id]
        lg = ts_logits(fa, [p1], f1[None], [na1])[0]
        n_bad, n_hard = near_tie_mismatches(torch.from_numpy(recorded[0][b][ts1]).long(),
                                            lg.argmax(-1).cpu(), top2_gap(lg))
        log(f"  align_batch item {s} s / {n} words vs a single bucketed pass: "
            f"{n_bad} of {len(ts1)} classes differ ({n_hard} outside near ties)")
        if n_hard:
            raise AssertionError(f"align_batch {s} s: classes differ outside near ties")

    stages = {"dense": align_stage_ms(fa, audio, text)}
    profile_align(fa, audio, text, "dense")
    del fa
    fa8 = load_aligner("auto")
    if not isinstance(fa8.params["decoder"]["layers"]["wqkv"], dict):
        raise AssertionError("quantize='auto' did not give the aligner int8pc layers")
    torch.cuda.synchronize()
    reset_counts()
    r = fa8.align(audio, text)
    torch.cuda.synchronize()
    got = window("aligner auto", None, counts())
    want = dict(no_launches(), flash=L, **prefill_want(1, True, L))
    log(f"  align auto (int8pc layers): launches {got}")
    if got != want:
        raise AssertionError(f"aligner auto: launch counts {got} != {want}")
    check_words("aligner auto", r, ALIGN_WORDS, float(ALIGN_SECONDS))
    stages["auto"] = align_stage_ms(fa8, audio, text)
    profile_align(fa8, audio, text, "auto")
    for mode, st in stages.items():
        log(f"  aligner stage ms ({mode}; median of {ALIGN_REPS}): mel {st['mel']:.4f}, "
            f"encode {st['encode']:.4f}, NAR classify {st['classify']:.4f}, host "
            f"{st['host']:.4f}; align staged {st['staged']:.4f}, fused {st['fused']:.4f}")
    phase_combined_and_server(fa8)
    log(f"phase aligner: {time.perf_counter() - t_phase:.1f} s")
    return got_launches, stages


def phase_combined_and_server(fa):
    """`transcribe_and_align` and `ASRServer(aligner=fa)` over HTTP with the
    CLI's default ASR (quantize="auto", EOS off) whose tokens decode to
    words."""
    import base64
    import json
    import threading
    import urllib.request

    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.pipeline.combined import transcribe_and_align
    from qwen3_asr_tpu_torch.serve import ASRServer, serve_http
    from qwen3_asr_tpu_torch.text import extract_transcript
    from qwen3_asr_tpu_torch.text.subtitles import words_to_srt

    cfg = ASRModelConfig()
    asr = Qwen3ASR(quantize="auto", device="cuda")
    asr.load_random(cfg, seed=0, vocab=byte_vocab(cfg.decoder.vocab_size, word_tokens=True))
    eos_off(asr)
    audio = align_pcm(ALIGN_SECONDS)
    want = asr.transcribe(audio, tparams(32))
    t0 = time.perf_counter()
    out = transcribe_and_align(asr, fa, audio, tparams(32))
    ms = (time.perf_counter() - t0) * 1e3
    log(f"  transcribe_and_align (auto, fused, 92 s, 32 tokens): {ms:.1f} ms, "
        f"success={out.success}, {len(out.alignment.words) if out.alignment else 0} words, "
        f"transcript {out.transcript[:60]!r}...")
    if not out.success or out.asr.tokens != want.tokens:
        raise AssertionError("transcribe_and_align: the ASR leg's tokens differ from "
                             "transcribe's")
    check_words("transcribe_and_align", out.alignment, len(out.transcript.split()),
                float(ALIGN_SECONDS))

    params = TranscribeParams(max_tokens=32, mel_bucket=ALIGN_BUCKET, print_timing=False)
    server = ASRServer(asr, params, max_batch=4, aligner=fa)
    httpd = serve_http(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body, ctype):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()

    def multipart(fields):
        b = "chipsmokealign"
        body = b"".join(f"--{b}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n"
                        .encode() + (v if isinstance(v, bytes) else v.encode()) + b"\r\n"
                        for k, v in fields.items()) + f"--{b}--\r\n".encode()
        return body, f"multipart/form-data; boundary={b}"

    def triples(words):
        return [(w["word"], w["start"], w["end"]) if isinstance(w, dict)
                else (w.word, w.start, w.end) for w in words]

    s30, t30 = align_pcm(30, seed=2), align_text(60)
    wav = wav_bytes(s30)
    try:
        codes, got = [], []
        code, body = post("/v1/align", *multipart({"audio": wav, "text": t30}))
        codes.append(code)
        got.append(triples(json.loads(body)["words"]))
        code, body = post("/v1/align", json.dumps({"audio_b64": base64.b64encode(wav).decode(),
                                                   "text": t30}).encode(), "application/json")
        codes.append(code)
        got.append(triples(json.loads(body)["words"]))
        want_align = triples(fa.align_batch([s30], [t30], mel_bucket=ALIGN_BUCKET)[0].words)
        code, srt = post("/v1/audio/transcriptions",
                         *multipart({"file": wav, "response_format": "srt"}))
        codes.append(code)
        code, body = post("/v1/audio/transcriptions",
                          *multipart({"file": wav, "response_format": "verbose_json",
                                      "timestamp_granularities[]": "word"}))
        codes.append(code)
        verbose = json.loads(body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    transcript = extract_transcript(asr.transcribe(s30, params).text)
    want_words = triples(fa.align_batch([s30], [transcript], mel_bucket=ALIGN_BUCKET)[0].words)
    log(f"  HTTP with --aligner-model: codes {codes}; /v1/align {len(got[0])} words "
        f"(multipart == JSON == align_batch: {got[0] == got[1] == want_align}); OpenAI "
        f"verbose_json {len(verbose['words'])} words, srt {srt.count(b'-->')} cues")
    if codes != [200] * 4:
        raise AssertionError(f"an HTTP request with the aligner was not answered 200: {codes}")
    if not (got[0] == got[1] == want_align) or len(want_align) != 60:
        raise AssertionError("/v1/align words differ from align_batch's")
    if triples(verbose["words"]) != want_words or not want_words:
        raise AssertionError("the OpenAI route's words differ from the aligner's")
    from qwen3_asr_tpu_torch.pipeline.aligner import AlignedWord

    if srt.decode() != words_to_srt([AlignedWord(*w) for w in want_words]):
        raise AssertionError("the OpenAI route's srt differs from the aligner's words")


# ---------------------------------------------------------------------------
# sampled decoding and greedy self-speculation
# ---------------------------------------------------------------------------

SAMPLE_SECONDS = 92
SAMPLE_CHECK = 24       # tokens held against greedy and, teacher-forced, the twins
SAMPLED = dict(temperature=1.0, top_k=50, top_p=0.9)
# A sampled token outside the twin's kept set passes only within EDGE_TOL
# (logits at temperature 1) of the set's smallest kept logit: its
# probability within e^0.2 of the cutoff's, where K1's rounding against the
# twin's (MEGA_H_REL) moves the set's edge.
EDGE_TOL = NEAR_TIE_TOL
SPEC_KS, SPEC_TOKENS = (1, 4, 8), 323
SPEC_SHORT = 32         # spec tokens at k 1 and on the int4 pack; the reference's
SPEC_LONG = (640, 16)   # seconds, tokens: a prompt of ~8,330 rows, S past LONG_S


def kept_ref(logits, temperature: float, top_k: int, top_p: float):
    """The reference's kept set, written apart from filter_logits: the
    logits over the temperature (clamped at 1e-4), sorted descending; the
    first top_k and their ties; then the prefix through the first index
    whose inclusive cumsum of the kept softmax (in float64, as
    filter_logits sums it) reaches top_p, and the logits tied with its
    last. -> bool [V]."""
    import numpy as np
    import torch

    t = max(np.float32(temperature), np.float32(1e-4))
    x = logits.float() / torch.tensor(t, dtype=torch.float32, device=logits.device)
    srt = torch.sort(x, descending=True).values
    cut = srt[top_k - 1] if 0 < top_k < x.numel() else srt[-1]
    if top_p < 1.0:
        p = torch.softmax(torch.where(srt >= cut, srt, float("-inf")), dim=-1).double()
        n = int((torch.cumsum(p, dim=-1) < float(np.float32(top_p))).sum()) + 1
        cut = torch.maximum(cut, srt[min(n, x.numel()) - 1])
    return x >= cut


def check_sampled(what: str, asr, samples, tokens, rows, temperature: float,
                  top_k: int, top_p: float) -> tuple[int, float, float]:
    """A sampled request's tokens and the rows its head was given, against
    the twins teacher-forced on those tokens: every row within MEGA_H_REL
    relative L2 of the twin's h (the hidden state before the final norm);
    filter_logits' kept set on the twin's logits (the tree's lm_logits of
    its h) equal to kept_ref's; every token inside that set, or within
    EDGE_TOL of its smallest kept logit. -> (tokens at the edge, worst h rel
    L2, mean kept-set size)."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models.generate import NEG, filter_logits

    dec, dcfg = asr.params["decoder"], asr.cfg.decoder
    rels, sizes, edge = [], [], 0
    for i, ((h, _), tok, row) in enumerate(zip(twin_steps(asr, samples, tokens),
                                               tokens, rows)):
        rels.append(_rel(row.reshape(-1), h.reshape(-1)))
        lg = dmod.lm_logits(dec, dcfg, h.reshape(-1))
        keep = kept_ref(lg, temperature, top_k, top_p)
        if not torch.equal(filter_logits(lg, temperature, top_k, top_p) > NEG, keep):
            raise AssertionError(f"{what}: filter_logits' kept set differs from the "
                                 f"reference's at step {i}")
        sizes.append(int(keep.sum()))
        if not bool(keep[tok]):
            x = lg.float() / temperature
            gap = float(x[keep].min() - x[tok])
            if gap > EDGE_TOL:
                raise AssertionError(f"{what}: step {i} token {tok} outside the twin's "
                                     f"kept set by {gap:.4f}")
            edge += 1
    log(f"  {what}: {len(tokens)} sampled tokens vs the twins' kept sets: {edge} at "
        f"the edge (within {EDGE_TOL}), kept set {sum(sizes) / len(sizes):.1f} tokens "
        f"on average; head rows vs the twins' h: rel L2 max {max(rels):.3e}")
    if max(rels) > MEGA_H_REL:
        raise AssertionError(f"{what}: the sampled head's row differs from the twin's h "
                             f"by {max(rels):.3f} rel L2")
    return edge, max(rels), sum(sizes) / len(sizes)


def check_greedy_limit(what: str, asr, samples, greedy, limit) -> int:
    """temperature 0.8 with top_k 1, the argmax of lm_logits (the tree's
    int8pc or Q8_0 head) on the step's h, against the greedy path's tokens,
    the argmax of the kernel's own head. Where the two heads are one (the
    int8 pack, q8_0): equal up to the first difference, which must be a near
    tie in the twins' lm_logits teacher-forced on the greedy tokens. The
    int4 pack's K1 head is int4 (the sampled head int8pc), so there the
    first 16 top_k 1 tokens hold against the twins' lm_logits argmax
    teacher-forced on them (the near-tie rule) and their first departure
    from greedy is only reported. -> the index of that departure (len when
    none)."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops.megakernel import weight_bits

    dec, dcfg = asr.params["decoder"], asr.cfg.decoder
    if len(limit) != len(greedy):
        raise AssertionError(f"{what}: {len(limit)} tokens at top_k 1, {len(greedy)} greedy")
    diff = [i for i, (a, b) in enumerate(zip(greedy, limit)) if a != b]
    j = diff[0] if diff else len(greedy)
    if "mega" in dec and weight_bits(dec["mega"]) == 4:
        gaps = []
        for (h, _), tok in zip(twin_steps(asr, samples, limit[:16]), limit):
            lg = dmod.lm_logits(dec, dcfg, h.reshape(-1))
            gaps.append(float(lg.max() - lg[tok]))
        log(f"  {what}: top_k 1 vs the twins' int8pc head, teacher-forced: worst gap "
            f"{max(gaps):.4f}; it leaves K1's int4-head greedy tokens at step {j}")
        if max(gaps) > NEAR_TIE_TOL:
            raise AssertionError(f"{what}: top_k 1 token off the int8pc head's argmax by "
                                 f"{max(gaps):.4f}")
        return j
    if not diff:
        return j
    h = twin_steps(asr, samples, greedy[:j + 1])[j][0]
    lg = dmod.lm_logits(dec, dcfg, h.reshape(-1))
    gap = abs(float(lg[greedy[j]] - lg[limit[j]]))
    log(f"  {what}: top_k 1 leaves the greedy tokens at step {j}, a gap of {gap:.4f}")
    if gap > NEAR_TIE_TOL:
        raise AssertionError(f"{what}: top_k 1 differs from greedy at step {j} by {gap:.4f}")
    return j


def check_rows_replay(what: str, asr, tokens, rows, max_tokens: int) -> None:
    """The rows a sampled request's head was given (its first len(tokens)),
    against the kernels' eager steps teacher-forced on the drawn tokens from
    the same prefill (decode_args, the cache of the request's S): equal bit
    for bit, as a graph replay equals the eager step when it consumes the
    drawn token. A loop that fed K1's own argmax instead leaves the rows
    from the second on different."""
    import torch

    from qwen3_asr_tpu_torch.models import generate as gen
    from qwen3_asr_tpu_torch.ops.megakernel import DecodeStep

    dec, dcfg, toks, n_prompt, feats, n_audio, off, _ = decode_args(
        asr, SAMPLE_SECONDS, max_tokens)
    kv = gen.kv_dtype(dec, asr.cache_dtype)
    h, cache = gen.prefill_hidden(dec, dcfg, toks, n_prompt, feats, n_audio, off,
                                  gen.cache_rows(toks.shape[0], max_tokens), kv)
    got = [h]
    step = (DecodeStep(dec["mega"], dcfg, *gen.mega_caches(dcfg, cache, kv))
            if "mega" in dec else None)
    nxt = torch.empty(1, dtype=torch.int32, device="cuda")
    for i in range(1, len(tokens)):
        t = torch.tensor([tokens[i - 1]], dtype=torch.int32, device="cuda")
        if step is None:
            got.append(gen.decode_hidden(dec, dcfg, cache, t, n_prompt + i - 1))
        else:
            step(t, n_prompt + i - 1, nxt)
            got.append(step.h.clone())
    bad = [i for i, (a, b) in enumerate(zip(got, rows))
           if not torch.equal(a.reshape(-1), b.reshape(-1))]
    log(f"  {what}: head rows equal to the eager steps' on {len(tokens) - len(bad)} of "
        f"{len(tokens)} steps")
    if bad:
        raise AssertionError(f"{what}: the head's rows differ from the eager steps fed "
                             f"the drawn tokens at steps {bad[:8]}")


def decode_args(asr, seconds: float, max_tokens: int) -> tuple:
    """The staged path's decode arguments for one request of `seconds`
    (mel and the encoder with the kernels, the prompt padded to 128 rows):
    (dec, dcfg, tokens, n_prompt, feats, n_audio, offset, max_tokens)."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.audio.mel import mel_device
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
    from qwen3_asr_tpu_torch.models.encoder import encode
    from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt

    dcfg = asr.cfg.decoder
    buf, n_frames = _pad_pcm(pcm(seconds))
    mel = mel_device(torch.from_numpy(buf).cuda(), asr.filters_t, n_frames).T
    feats = encode(asr.params["encoder"], asr.cfg.encoder, mel, n_frames)
    n_audio = int(feats.shape[0])
    prompt = build_asr_prompt(n_audio, dcfg)
    toks = np.full(-(-len(prompt) // 128) * 128, dcfg.pad_token_id, np.int32)
    toks[:len(prompt)] = prompt
    return (asr.params["decoder"], dcfg, torch.from_numpy(toks).cuda(), len(prompt),
            feats, n_audio, audio_start_pos(prompt, dcfg), max_tokens)


def event_ms(fn) -> float:
    """Milliseconds between CUDA events around fn() (host work included)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def decode_step_ms(run, steps: int, reps: int = 5) -> float:
    """Decode ms/step of run(max_tokens): (the median of reps runs of
    steps + 1 tokens minus the median of reps runs of one) / steps; each
    run has its prefill and, on a pack, its graph capture."""
    import statistics

    many = statistics.median(event_ms(lambda: run(steps + 1)) for _ in range(reps))
    one = statistics.median(event_ms(lambda: run(1)) for _ in range(reps))
    return (many - one) / steps


def phase_sampling(asr, label: str, wbits, key: str | None, n_tokens: int,
                   timed_steps: int) -> dict:
    """Sampled decoding through `Qwen3ASR.transcribe` on the bench's 92 s
    audio (EOS off): temperature 0 gives transcribe's greedy tokens
    exactly; temperature 0.8 with top_k 1 gives them under the near-tie rule
    (check_greedy_limit); one request at temperature 1.0, top_k 50, top_p
    0.9, seed 3 of n_tokens is a launch window (K2 once per decoder layer,
    and the decode pack's entry `key` once per step, or the per-layer
    step's K4-K7 as slice_launches counts them), its head's rows recorded;
    the same seed again gives the same tokens, seed 4 others; its first
    SAMPLE_CHECK rows equal the kernels' eager steps fed its tokens bit for
    bit (check_rows_replay), and its tokens and rows hold against the twins
    (check_sampled). Then sampled and greedy decode ms/step (generate_sample
    / generate_greedy on the same prompt, decode_step_ms over timed_steps).
    -> the readings."""
    from qwen3_asr_tpu_torch.models import generate as gen

    t_phase = time.perf_counter()
    samples = pcm(SAMPLE_SECONDS)
    L = asr.cfg.decoder.n_layers
    greedy = asr.transcribe(samples, tparams(SAMPLE_CHECK)).tokens
    if asr.transcribe(samples, tparams(SAMPLE_CHECK, temperature=0.0)).tokens != greedy:
        raise AssertionError(f"sampled {label}: temperature 0 differs from greedy")
    limit = asr.transcribe(samples, tparams(SAMPLE_CHECK, temperature=0.8, top_k=1)).tokens
    j = check_greedy_limit(f"sampled {label}", asr, samples, greedy, limit)
    rows = []
    head = gen.lm_logits

    def recording(d, c, h):
        rows.append(h.detach().clone())
        return head(d, c, h)

    gen.lm_logits = recording
    try:
        r, ms, got = timed_request(asr, SAMPLE_SECONDS, n_tokens, seed=3, **SAMPLED)
    finally:
        gen.lm_logits = head
    what = f"sampled {label}, 92 s / {n_tokens}"
    log(f"request {what} (t 1.0, top_k 50, top_p 0.9, seed 3): {ms:.1f} ms, "
        f"{len(r.tokens)} tokens; launches {got}")
    if key is None:
        window(what, wbits, got)
        want = slice_launches("q8_0", prompt_rows(SAMPLE_SECONDS), n_tokens, L)
        if got != want or len(r.tokens) != n_tokens:
            raise AssertionError(f"{what}: launch counts {got} != {want} or "
                                 f"{len(r.tokens)} tokens")
    else:
        check_window(what, wbits, got, r, n_tokens, **{key: n_tokens - 1})
    if len(rows) != n_tokens:
        raise AssertionError(f"{what}: the head ran {len(rows)} times")
    again = timed_request(asr, SAMPLE_SECONDS, n_tokens, seed=3, **SAMPLED)[0].tokens
    other = timed_request(asr, SAMPLE_SECONDS, SAMPLE_CHECK, seed=4, **SAMPLED)[0].tokens
    if again != r.tokens or other == r.tokens[:SAMPLE_CHECK]:
        raise AssertionError(f"{what}: seed 3 twice equal {again == r.tokens}, "
                             f"seed 4 equal {other == r.tokens[:SAMPLE_CHECK]}")
    n_same = sum(a == b for a, b in zip(r.tokens, greedy))
    check_rows_replay(what, asr, r.tokens[:SAMPLE_CHECK], rows, n_tokens)
    edge, rel, size = check_sampled(what, asr, samples, r.tokens[:SAMPLE_CHECK],
                                    rows[:SAMPLE_CHECK], **SAMPLED)
    args = decode_args(asr, SAMPLE_SECONDS, 1)[:-1]
    kv = asr.cache_dtype
    ms_s = decode_step_ms(lambda n: gen.generate_sample(*args, n, seed=3, cache_dtype=kv,
                                                        **SAMPLED), timed_steps)
    ms_g = decode_step_ms(lambda n: gen.generate_greedy(*args, n, kv), timed_steps)
    seconds = time.perf_counter() - t_phase
    log(f"phase sampling {label}: sampled {ms_s:.4f} ms/step, greedy {ms_g:.4f} ms/step "
        f"(92 s prompt, medians of 5, {timed_steps} steps); top_k 1 equal to greedy "
        f"for the first {j} of {SAMPLE_CHECK} tokens; the sampled request shares {n_same} of "
        f"{SAMPLE_CHECK} positions with greedy's; {seconds:.1f} s")
    return {"launches": got, "sampled_ms_step": ms_s, "greedy_ms_step": ms_g,
            "edge": edge, "h_rel": rel, "kept": size, "seconds": seconds}


def int8pc_greedy(vparams: dict, args: tuple):
    """The per-layer int8pc greedy loop over an int8 cache (the block decode
    at T = 1, decode_token per step), on decode_args' prompt: -> (tokens,
    the logits of each step)."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models import generate as gen

    _, dcfg, toks, n_prompt, feats, n_audio, off, max_tokens = args
    S = gen.cache_rows(toks.shape[0], max_tokens)
    h, cache = gen.prefill_hidden(vparams, dcfg, toks, n_prompt, feats, n_audio, off, S,
                                  torch.int8)
    out = torch.zeros(max_tokens, dtype=torch.int32, device="cuda")
    logits = [dmod.lm_logits(vparams, dcfg, h)]
    out[0] = torch.argmax(logits[0])
    logits += [gen.decode_token(vparams, dcfg, cache, out, i, n_prompt + i - 1)
               for i in range(1, max_tokens)]
    return out.cpu().tolist(), logits


def check_spec_tokens(what: str, got, ref, ref_logits) -> int:
    """Spec tokens against the int8pc greedy sequence (its first len(ref)):
    equal up to the first difference, which must be a near tie in the
    reference's logits at that step. -> the index (len(ref) when none)."""
    diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if len(got) < len(ref):
        raise AssertionError(f"{what}: {len(got)} tokens")
    if not diff:
        return len(ref)
    j = diff[0]
    gap = abs(float(ref_logits[j][ref[j]] - ref_logits[j][got[j]]))
    log(f"  {what}: leaves the int8pc greedy sequence at step {j}, a gap of {gap:.4f}")
    if gap > NEAR_TIE_TOL:
        raise AssertionError(f"{what}: differs from int8pc greedy at step {j} by {gap:.4f}")
    return j


def check_spec_teacher_forced(what: str, vparams: dict, args: tuple, tokens) -> float:
    """Every token of a spec request against one block decode teacher-forced
    on them (the prefill, then rows tokens[:-1] at the positions after the
    prompt, the int8pc leaves over an int8 cache): each the block's argmax
    or within NEAR_TIE_TOL of it. -> the worst gap."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.models import generate as gen

    _, dcfg, toks, n_prompt, feats, n_audio, off, _ = args
    n = len(tokens)
    h, cache = gen.prefill_hidden(vparams, dcfg, toks, n_prompt, feats, n_audio, off,
                                  gen.cache_rows(toks.shape[0], n), torch.int8)
    x = vparams["token_embd"][torch.tensor(tokens[:-1], device="cuda").long()]
    hb = dmod.decoder_forward(vparams, dcfg, x, cache, n_prompt + n - 1, prefill=False,
                              cache_offset=n_prompt)
    lg = dmod.lm_logits_block(vparams, dcfg, torch.cat([h[None].to(hb.dtype), hb]))
    t = torch.tensor(tokens, device="cuda")
    gaps = (lg.max(dim=-1).values - lg[torch.arange(n, device="cuda"), t]).cpu()
    log(f"  {what}: {n} tokens vs one teacher-forced block of {n - 1} rows: "
        f"{int((gaps == 0).sum())} argmax-equal, worst gap {float(gaps.max()):.4f}")
    if float(gaps.max()) > NEAR_TIE_TOL:
        raise AssertionError(f"{what}: a token is off the teacher-forced block's argmax "
                             f"by {float(gaps.max()):.4f}")
    return float(gaps.max())


def phase_spec(auto, asr4) -> dict:
    """Greedy self-speculation (`generate_greedy_spec`) on the bench's 92 s
    audio (EOS off) with the auto model's int8 pack and the int4 pack (both
    load seed 0, so their int8pc leaves, the verify's, are the same), k in
    SPEC_KS: 323 tokens at k 4 and 8 on the int8 pack, SPEC_SHORT tokens at
    k 1 and on the int4 pack (its drafts are seldom accepted on random
    weights: about one token a round). Each run is a launch window (K2 once
    per decoder layer, K1's int8-cache entry once per drafted token, nothing
    else: the verify pass is plain torch). Its first SPEC_SHORT tokens hold
    against the per-layer int8pc greedy loop over an int8 cache
    (int8pc_greedy): at k = 1 equal, and every verify pass's logits equal
    that loop's step logits bit for bit (the same computation on the same
    cache rows; a verify that read the drafts' rows would differ); else
    equal up to a near tie. The 323-token runs hold against one
    teacher-forced block (check_spec_teacher_forced). ms per emitted token
    beside K1 greedy's ms/step on the same pack and cache.
    `Qwen3ASR.transcribe(spec_k=4)` gives the direct call's tokens; one
    request of SPEC_LONG (a cache past LONG_S) runs with k = 8 and holds
    against its int8pc greedy tokens. -> readings by (pack, k)."""
    import torch

    from qwen3_asr_tpu_torch.models import generate as gen

    t_phase = time.perf_counter()
    da, d4 = auto.params["decoder"], asr4.params["decoder"]
    if not torch.equal(da["lm_head_pc"]["i8pc:q"], d4["lm_head_pc"]["i8pc:q"]):
        raise AssertionError("spec: the two models' int8pc leaves differ")
    args = decode_args(auto, SAMPLE_SECONDS, SPEC_TOKENS)
    vparams = {k: v for k, v in da.items() if k != "mega"}
    t0 = time.perf_counter()
    ref, ref_logits = int8pc_greedy(vparams, args[:-1] + (SPEC_SHORT,))
    ref_ms = (time.perf_counter() - t0) * 1e3
    log(f"phase spec: int8pc greedy reference, 92 s / {SPEC_SHORT}: {ref_ms:.1f} ms "
        f"({ref_ms / SPEC_SHORT:.2f} ms a token, the prefill included)")
    L = auto.cfg.decoder.n_layers
    out = {}
    for label, model, wbits in (("auto", auto, 8), ("int4", asr4, 4)):
        margs = (model.params["decoder"],) + args[1:-1]
        one = event_ms(lambda: gen.generate_greedy_spec(*margs, 1, k=4))
        g_ms = (event_ms(lambda: gen.generate_greedy(*margs, SPEC_TOKENS, torch.int8))
                - event_ms(lambda: gen.generate_greedy(*margs, 1, torch.int8))
                ) / (SPEC_TOKENS - 1)
        for k in SPEC_KS:
            n_tok = SPEC_TOKENS if label == "auto" and k > 1 else SPEC_SHORT
            verify_logits = []
            head = gen.lm_logits_block

            def recording(d, c, h):
                lg = head(d, c, h)
                verify_logits.append(lg)
                return lg

            torch.cuda.synchronize()
            reset_counts()
            res = []
            gen.lm_logits_block = recording
            try:
                ms = event_ms(lambda: res.append(gen.generate_greedy_spec(*margs, n_tok,
                                                                          k=k)))
            finally:
                gen.lm_logits_block = head
            toks, n, st = res[0]
            what = f"spec {label} k={k}"
            got = window(what, wbits, counts())
            want = dict(no_launches(), flash=L, mega=st["drafted"], **prefill_want(1, True, L))
            per_tok = (ms - one) / (n_tok - 1)
            log(f"request {what}, 92 s / {n_tok}: {ms:.1f} ms; rounds {st['rounds']} "
                f"(verify passes), accepted {st['accepted']}/{st['drafted']} "
                f"({st['accepted'] / st['drafted']:.1%}); {per_tok:.4f} ms per emitted token "
                f"(K1 greedy, int8 KV: {g_ms:.4f} ms/step); launches {got}")
            if got != want or n != n_tok or len(verify_logits) != st["rounds"]:
                raise AssertionError(f"{what}: launch counts {got} != {want}, {n} tokens "
                                     f"or {len(verify_logits)} verify passes")
            toks = [int(t) for t in toks[:n]]
            j = check_spec_tokens(what, toks, ref, ref_logits)
            if k == 1:
                same = [torch.equal(a[0], b) for a, b in zip(verify_logits, ref_logits[1:])]
                log(f"  {what}: verify logits equal to the int8pc loop's on "
                    f"{sum(same)} of {len(same)} steps")
                if j != SPEC_SHORT or not all(same):
                    raise AssertionError(f"{what}: differs from the int8pc greedy loop")
            if n_tok == SPEC_TOKENS:
                check_spec_teacher_forced(what, vparams, args, toks)
            out[(label, k)] = {"ms_per_token": per_tok, "greedy_ms_step": g_ms,
                               "tokens": n_tok, "rounds": st["rounds"],
                               "drafted": st["drafted"], "accepted": st["accepted"],
                               "equal_to": j, "launches": got, "out": toks}
    via = auto.transcribe(pcm(SAMPLE_SECONDS), tparams(SPEC_SHORT, spec_k=4)).tokens
    if via != out[("auto", 4)]["out"][:SPEC_SHORT]:
        raise AssertionError("spec: transcribe(spec_k=4) differs from the direct call")
    seconds, n_tok = SPEC_LONG
    rows = []
    init = gen.init_kv_cache

    def recording_cache(cfg, n_ctx, *a, **kw):
        rows.append(n_ctx)
        return init(cfg, n_ctx, *a, **kw)

    gen.init_kv_cache = recording_cache
    try:
        r = auto.transcribe(pcm(seconds), tparams(n_tok, spec_k=8))
    finally:
        gen.init_kv_cache = init
    largs = decode_args(auto, seconds, n_tok)
    lref, llogits = int8pc_greedy(vparams, largs)
    log(f"  spec auto k=8 on {seconds} s / {n_tok}: prompt {largs[3]} rows, cache "
        f"S {rows}")
    if not r.success or rows != [rows[0]] or rows[0] <= LONG_S:
        raise AssertionError(f"spec long: success {r.success}, cache rows {rows}")
    check_spec_tokens(f"spec auto k=8, {seconds} s", r.tokens, lref, llogits)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase spec: {out['seconds']:.1f} s")
    return out


def phase_server_sampling(auto) -> None:
    """`qwen3-asr-cuda-serve`'s default (auto with the int8 cache, closed
    batches) behind serve_http, with a word vocabulary so texts differ: two
    greedy POST /v1/transcribe and one OpenAI request at temperature 0.7,
    seed 3, sent together: the greedy pair gets transcribe_batch's text, the
    sampled one (run alone) transcribe's with its parameters; the sampled
    request again gives the same text; temperature 3 and a sampled stream
    answer 400 with the JAX package's messages."""
    import dataclasses as dc
    import json
    import threading
    import urllib.error
    import urllib.request

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.serve import ASRServer, serve_http
    from qwen3_asr_tpu_torch.text.bpe import BPETokenizer
    from qwen3_asr_tpu_torch.text.prompt import extract_transcript

    t_phase = time.perf_counter()
    asr = like(auto, "int8")
    asr.tokenizer = BPETokenizer(byte_vocab(asr.cfg.decoder.vocab_size, True), [])
    params = TranscribeParams(max_tokens=ENGINE_TOKENS, mel_bucket=ENGINE_KW["mel_bucket"],
                              print_timing=False)
    server = ASRServer(asr, params, max_batch=4, max_wait_ms=1000)
    httpd = serve_http(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    boundary = "chipsmokesampling"

    def openai(samples, **fields):
        body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
                f"filename=\"a.wav\"\r\n\r\n").encode() + wav_bytes(samples) + b"\r\n"
        for name, value in fields.items():
            body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\""
                     f"\r\n\r\n{value}\r\n").encode()
        return post("/v1/audio/transcriptions", body + f"--{boundary}--\r\n".encode(),
                    f"multipart/form-data; boundary={boundary}")

    def post(path, body, ctype):
        req = urllib.request.Request(base + path, data=body, headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=600) as rsp:
                return rsp.status, json.loads(rsp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    g1, g2, s = pcm(15, 60), pcm(30, 61), pcm(30, 62)
    replies = {}
    try:
        jobs = [("g1", lambda: post("/v1/transcribe", wav_bytes(g1), "audio/wav")),
                ("sampled", lambda: openai(s, temperature="0.7", seed="3")),
                ("g2", lambda: post("/v1/transcribe", wav_bytes(g2), "audio/wav"))]
        threads = [threading.Thread(target=lambda n=n, f=f: replies.__setitem__(n, f()))
                   for n, f in jobs]
        for th in threads:
            th.start()
            time.sleep(0.05)
        for th in threads:
            th.join(600)
        replies["again"] = openai(s, temperature="0.7", seed="3")
        replies["t3"] = openai(s, temperature="3")
        replies["stream"] = openai(s, temperature="0.5", stream="true")
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    log("phase server sampling: " + ", ".join(f"{k} {v[0]}" for k, v in replies.items())
        + f"; {server.n_batches} rounds")
    batch = asr.transcribe_batch([g1, g2], params)
    sampled = asr.transcribe(s, dc.replace(params, temperature=0.7, seed=3))
    if [(c, p.get("text")) for c, p in (replies["g1"], replies["g2"])] != \
            [(200, b.text) for b in batch]:
        raise AssertionError("server sampling: the greedy pair differs from "
                             "transcribe_batch's")
    want = extract_transcript(sampled.text)
    if replies["sampled"] != (200, {"text": want}) or replies["again"] != replies["sampled"]:
        texts = [replies["sampled"][1].get("text", ""), replies["again"][1].get("text", ""),
                 want, extract_transcript(asr.transcribe(
                     s, dc.replace(params, temperature=0.7, seed=3)).text)]
        log(f"  server sampling: server twice equal {texts[0] == texts[1]}, to transcribe "
            f"{texts[0] == texts[2]}, transcribe twice equal {texts[2] == texts[3]}; "
            + " | ".join(t[:60] for t in texts))
        raise AssertionError(f"server sampling: sampled replies {replies['sampled'][0]}, "
                             f"{replies['again'][0]} differ from transcribe's")
    for k, msg in (("t3", "temperature must be in [0, 2]"),
                   ("stream", "stream=true is greedy-only (sampled decoding runs as "
                              "one whole-loop program)")):
        if replies[k][0] != 400 or replies[k][1]["error"]["message"] != msg:
            raise AssertionError(f"server sampling: {k} answered {replies[k]}")
    if server.n_batches != 3:   # the greedy pair, then two lone sampled requests
        raise AssertionError(f"server sampling: {server.n_batches} rounds")
    log(f"  greedy pair equal to transcribe_batch's text, sampled text "
        f"({len(want.split())} words) equal twice and to transcribe's; "
        f"{time.perf_counter() - t_phase:.1f} s")


def phase_cli_sampling(auto) -> None:
    """The CLI in this process, `qwen3-asr-cuda-cli -f x.wav --max-tokens
    32 --tokens` with `--temperature 0.7 --seed 3` and with `--spec-k 4`
    (default `--quantize auto`), Qwen3ASR.load_model giving the auto
    model's random weights (no GGUF of that size in the checkout): exit 0,
    the tokens on stderr equal transcribe's in that mode, the transcript
    alone on stdout."""
    import contextlib
    import io
    import os
    import re

    from qwen3_asr_tpu_torch import cli
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
    from qwen3_asr_tpu_torch.text.bpe import BPETokenizer

    t_phase = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(d, exist_ok=True)
    wav = os.path.join(d, "chip_smoke_cli.wav")
    with open(wav, "wb") as f:
        f.write(wav_bytes(pcm(5)))
    tok = BPETokenizer(byte_vocab(auto.cfg.decoder.vocab_size, True), [])

    def load(self, path):
        self.cfg, self.params, self.filters_t = auto.cfg, auto.params, auto.filters_t
        self.tokenizer = tok
        return True

    real = Qwen3ASR.load_model
    Qwen3ASR.load_model = load
    try:
        for flags, kw in ((["--temperature", "0.7", "--seed", "3"],
                           dict(temperature=0.7, seed=3)), (["--spec-k", "4"], dict(spec_k=4))):
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(["-m", "random-seed-0", "-f", wav, "--max-tokens", "32",
                               "--no-timing", "--tokens", *flags])
            got = [int(x) for x in re.findall(r"^  \[\d+\] (\d+)$", err.getvalue(), re.M)]
            model = like(auto, "bf16")
            model.tokenizer = tok
            want = model.transcribe(pcm(5), TranscribeParams(max_tokens=32,
                                                             print_timing=False, **kw))
            log(f"phase CLI {' '.join(flags)}: exit {rc}, {len(got)} tokens")
            if rc != 0 or got != want.tokens or out.getvalue() != want.text + "\n":
                raise AssertionError(f"CLI {flags}: exit {rc}, tokens equal "
                                     f"{got == want.tokens}")
    finally:
        Qwen3ASR.load_model = real
    log(f"  CLI tokens equal transcribe's in both modes; {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# batches in every mode: K4 batched, K3 over a bf16 cache, the per-layer step
# at B rows, transcribe_batch and the server's closed batches
# ---------------------------------------------------------------------------

BATCH_REQUESTS = (92, 30, 15, 5)   # seconds: one closed batch, four mel buckets
BATCH_TOKENS = 64
BATCH_TWIN_TOKENS = 16   # of each row, held against the twins teacher-forced
BATCH_MODES = (("q8_0", "bf16"), ("q8_0", "int8"), (False, "bf16"), ("auto", "bf16"))
STEP_BATCH_STEPS = 4
# The per-layer step at B rows vs the single-row step on each row's cache
# copy, teacher-forced. K5-K7 sum each output in one f32 order whatever T is
# and K4's batched rows are its one-row launches, so every row and step must
# be torch.equal to the single step's, tokens included. Held beside that: h
# rel L2 <= STEP_BATCH_H_REL on every row and step, tokens under the
# near-tie rule, every slab's other rows untouched, the fresh rows under the
# cache rule. The bound is this step's own, from when B-row products summed
# in another order than one-row ones: rel L2 <= 0.035 on either cache on an
# H100 80GB HBM3 (700 W); a fault in the attention output alone, which the
# cache rule cannot see, reads 0.55 (q roped one position late) and 2.6 (a
# row's newest 64 cache rows skipped)
# (tests/test_torch_chip_faults.py::test_batched_step_q_side_fault_caught).
STEP_BATCH_H_REL = 0.08


def phase_decode_attention_batch(dcfg, S: int = 1664) -> dict:
    """K4's batched mode at full width, B = 8 rows at spread offsets (64 ..
    1,600, one row roped 5 past its offset), bf16 and int8 caches of S rows:
    each row torch.equal to the one-row launch on its slab, every row
    against the twin under K4's tolerance, a grid bound of S with the bits
    of max(offsets), one kernel a call (kernels_a_call), and the in-kernel
    store torch.equal to store_kv_rows (what _store runs) on the decoder's
    pool layout (the slabs as layer 1 of [B, 3, S, n_kv * D]); the batch's
    ms beside 8 one-row launches and the bytes bound, timed as the batched
    step calls it, store on (into a copy of the slabs), the store-off time
    logged beside it. -> {cache: (max_abs_err, ms, twin ms, bound ms,
    bound_by, 8 one-row ms)}."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows
    from qwen3_asr_tpu_torch.ops import decode_attention as da
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

    NH, NKV, D = dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim
    B = 8
    offs = _spread(B)
    pos = [o + (5 if b == 3 else 0) for b, o in enumerate(offs)]
    od = torch.tensor(offs, dtype=torch.int32, device="cuda")
    pd = torch.tensor(pos, dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for cache in ("bf16", "int8"):
        qkv = torch.randn(B, (NH + 2 * NKV) * D, generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn(B, S, NKV, D, generator=g, device="cuda")
        v = torch.randn(B, S, NKV, D, generator=g, device="cuda")
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
        args = (qkv, k, v, qn, kn, od, pd, max(offs))
        got = da.decode_attention_batch(*args, **kw)
        at_s = da.decode_attention_batch(*args[:-1], S, **kw)
        want = da.decode_attention_batch_ref(qkv, k, v, qn, kn, offs, pos, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, at_s)):
            raise AssertionError(f"K4 batched ({cache}): a grid bound of S gives other "
                                 f"bits than max(offsets)")

        def one_row(b, kk=k, vv=v, skw=kw, store=False):
            rkw = dict(skw, k_scale=skw["k_scale"][b], v_scale=skw["v_scale"][b]) \
                if cache == "int8" else skw
            return da.decode_attention(qkv[b:b + 1], kk[b], vv[b], qn, kn, offs[b], pos[b],
                                       **rkw, store=store)

        for b in range(B):
            if not all(torch.equal(a[b:b + 1], r) for a, r in zip(got, one_row(b))):
                raise AssertionError(f"K4 batched row {b} ({cache} cache, offset "
                                     f"{offs[b]}) differs from the one-row launch")
        err = max(float((a - r).abs().max()) for a, r in zip(got, want))
        ratio = max(float(((a - r).abs() / (DA_ATOL * r.abs().max() + DA_RTOL * r.abs()))
                          .max()) for a, r in zip(got, want))
        # the batched step's call: store on, into a copy of the slabs
        tk, tv = k.clone(), v.clone()
        tkw = dict(kw, **({"k_scale": kw["k_scale"].clone(),
                           "v_scale": kw["v_scale"].clone()} if cache == "int8" else {}))
        targs = (qkv, tk, tv, qn, kn, od, pd, max(offs))
        ms = graph_ms(lambda: da.decode_attention_batch(*targs, **tkw, store=True))
        no_store = graph_ms(lambda: da.decode_attention_batch(*args, **kw))
        rows_ms = graph_ms(lambda: [one_row(b, tk, tv, tkw, True) for b in range(B)])
        plain = cuda_ms(lambda: da.decode_attention_batch_ref(qkv, tk, tv, qn, kn, offs, pos,
                                                              **tkw, store=True), 3)
        n_kernels = kernels_a_call(lambda: da.decode_attention_batch(*targs, **tkw,
                                                                     store=True))
        # the live rows read, qkv read, the f32 outputs and the B stored rows written
        nbytes = (sum(offs) + B) * row_bytes + B * (2 * qkv.shape[1]
                                                    + 4 * (NH + 2 * NKV) * D)
        b_ms, b_by = bound(nbytes, 4.0 * NH * D * sum(o + 1 for o in offs), F32_FLOPS)
        log(f"phase K4 batched, {cache} cache, B={B} offsets {offs[0]}..{offs[-1]} S={S}: "
            f"rows torch.equal to one-row launches, bound S the same bits; "
            f"max_abs_err={err:.3e} worst |err| / (atol + rtol |ref|) {ratio:.4f}; batch "
            f"with its store {ms:.4f} ms (graph; store off {no_store:.4f} ms; parent, "
            f"store off, {K4_PARENT_MS[cache]:.4f} ms), {n_kernels} kernel(s) a call; 8 "
            f"one-row launches with their stores {rows_ms:.4f} ms; twin with its store "
            f"{plain:.4f} ms; bound {b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.3f} MB)")
        if not ratio <= 1.0:
            raise AssertionError(f"K4 batched ({cache}) disagrees with its twin")
        if n_kernels != 1:
            raise AssertionError(f"K4 batched ({cache}): {n_kernels} kernels a call, not 1")

        # the store, on slabs laid out as layer 1 of the decoder's pool
        pool = {n: torch.zeros(B, 3, *t.shape[1:2], NKV * D if n in ("k", "v") else NKV,
                               dtype=t.dtype, device="cuda")
                for n, t in (("k", k), ("v", v), *((("k_s", kw["k_scale"]),
                                                    ("v_s", kw["v_scale"]))
                                                   if cache == "int8" else ()))}
        for n, t in (("k", k), ("v", v)):
            pool[n][:, 1] = t.flatten(-2)
        if cache == "int8":
            pool["k_s"][:, 1], pool["v_s"][:, 1] = kw["k_scale"], kw["v_scale"]
        bkw = {n: x for n, x in kw.items() if n not in ("k_scale", "v_scale")}

        def batched(c, st):
            return da.decode_attention_batch(
                qkv, c["k"][:, 1].unflatten(-1, (NKV, D)),
                c["v"][:, 1].unflatten(-1, (NKV, D)), qn, kn, od, pd, max(offs), **bkw,
                k_scale=c["k_s"][:, 1] if "k_s" in c else None,
                v_scale=c["v_s"][:, 1] if "v_s" in c else None, store=st)

        da.check_store(f"K4 batched {cache} store", batched, pool,
                       (torch.arange(B, device="cuda"), od.long()), view=lambda t: t[:, 1])
        log(f"  K4 batched {cache}: the in-kernel store torch.equal to store_kv_rows "
            f"(_store) in every slab")
        out[cache] = (err, ms, plain, b_ms, b_by, rows_ms)
    return out


def _cache_slab(cache: dict):
    """A cache dict of [L, S, ...] tensors as (k, v, k_s, v_s) with rows
    flattened to n_kv * head_dim, the layout _bad_cache_layers reads."""
    return [cache[n].flatten(2) for n in ("k", "v")] + [cache.get(n) for n in ("k_s", "v_s")]


def step_batch_cache(dcfg, pos0, S: int, kv: str, g):
    """The batched step's cache (k / v [B, L, S, n_kv * head_dim], int8 with
    scales [B, L, S, n_kv]) with slab b's rows < pos0[b] drawn from N(0,
    0.25), and a copy of each slab in the single step's layout [L, S, n_kv,
    head_dim]. -> (cache, [copy of slab b])."""
    import torch

    from qwen3_asr_tpu_torch.models.decoder import _quantize_kv_rows

    B, L, NKV, D = len(pos0), dcfg.n_layers, dcfg.n_kv_heads, dcfg.head_dim
    cdt = torch.int8 if kv == "int8" else torch.bfloat16
    cache = {n: torch.zeros(B, L, S, NKV * D, dtype=cdt, device="cuda") for n in ("k", "v")}
    if kv == "int8":
        cache.update({n: torch.zeros(B, L, S, NKV, device="cuda") for n in ("k_s", "v_s")})
    for b, p in enumerate(pos0):
        for n in ("k", "v"):
            rows = torch.randn(L, p, NKV, D, generator=g, device="cuda") * 0.5
            if kv == "int8":
                q, sc = _quantize_kv_rows(rows)
                cache[n][b, :, :p], cache[n + "_s"][b, :, :p] = q.flatten(2), sc
            else:
                cache[n][b, :, :p] = rows.flatten(2).to(torch.bfloat16)
    singles = [{n: (t[b].unflatten(-1, (NKV, D)) if n in ("k", "v") else t[b]).clone()
                for n, t in cache.items()} for b in range(B)]
    return cache, singles


def phase_step_batch(asr, kv: str) -> dict:
    """The per-layer decode step at B = 8 rows (Q8_0 leaves: K6 / K5 / K7 at
    T = 8 and K4 batched) against the single-row step (K6 / K5 / K7 at T =
    1, K4 one row) on each row's cache copy, STEP_BATCH_STEPS steps at
    spread positions (S = MEGA_BATCH_S), teacher-forced on the single rows'
    tokens and cache rows: every row and step torch.equal to the single
    step's and no token mismatch; beside that, tokens under the near-tie
    rule, h rel L2 <= STEP_BATCH_H_REL, every slab's rows other than the
    fresh one torch.equal to its copy's, the fresh rows under the cache
    rule (all layers on a bit-exact row, layer 0 on the others). Then the
    batched step's wall, enqueue and device-busy ms beside 8 single steps',
    and the device time split into the Q8_0 body (K5-K7), K4 and the rest.
    -> the readings."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod

    dcfg, dec = asr.cfg.decoder, asr.params["decoder"]
    S, B = MEGA_BATCH_S, 8
    pos0 = _spread(B)
    g = torch.Generator(device="cuda").manual_seed(300)
    cache, singles = step_batch_cache(dcfg, pos0, S, kv, g)
    toks = torch.arange(1000, 1000 + B, device="cuda") % dcfg.vocab_size
    rels, equal, mism, worst_gap = [], [], 0, 0.0
    for i in range(STEP_BATCH_STEPS):
        pos = [p + i for p in pos0]
        x = dec["token_embd"][toks]
        h = dmod.decode_step_batch(dec, dcfg, x, cache,
                                   torch.tensor(pos, dtype=torch.int32, device="cuda"), pos)
        tok_b = torch.argmax(dmod.lm_logits_block(dec, dcfg, h), dim=-1)
        nxt = []
        for b, p in enumerate(pos):
            hs = dmod.decoder_forward(dec, dcfg, x[b:b + 1], singles[b], p + 1,
                                      prefill=False, cache_offset=p)
            lg = dmod.lm_logits(dec, dcfg, hs[0])
            ts = int(torch.argmax(lg))
            rels.append(_rel(h[b:b + 1], hs))
            equal.append(torch.equal(h[b:b + 1], hs))
            if int(tok_b[b]) != ts:
                mism += 1
                worst_gap = max(worst_gap, float(lg[ts] - lg[int(tok_b[b])]))
            one = _cache_slab(singles[b])
            for n, t, c in zip(("k", "v", "k_s", "v_s"), _cache_slab(
                    {n: t[b] for n, t in cache.items()}), one):
                if t is not None and not (torch.equal(t[:, :p], c[:, :p])
                                          and torch.equal(t[:, p + 1:], c[:, p + 1:])):
                    raise AssertionError(f"batched step, step {i} row {b}: cache {n} "
                                         f"changed outside row {p}")
            bad = _bad_cache_layers(_cache_slab({n: t[b] for n, t in cache.items()}), one, p)
            if bad and (rels[-1] == 0.0 or bad[0] == 0):
                raise AssertionError(f"batched step, step {i} row {b}: fresh cache rows "
                                     f"of layers {bad} differ from the single step's")
            for n, c in zip(("k", "v", "k_s", "v_s"), one):   # teacher-force the
                if c is not None:                              # single rows' cache row
                    cache[n][b, :, p] = c[:, p]
            nxt.append(ts)
        toks = torch.tensor(nxt, device="cuda")
    n_exact = sum(equal)
    log(f"phase batched per-layer step (q8_0, {kv} KV) vs single rows, "
        f"{STEP_BATCH_STEPS} steps x {B} rows at pos {pos0[0]}..{pos0[-1]}: rel_l2(h) max "
        f"{max(rels):.4f}, bit-equal on {n_exact}/{len(rels)}; token mismatches {mism} "
        f"(worst single-step logit gap {worst_gap:.4f})")
    if worst_gap > NEAR_TIE_TOL or not max(rels) <= STEP_BATCH_H_REL:
        raise AssertionError(f"the batched step disagrees with the single-row step: "
                             f"rel_l2 {max(rels)}, gap {worst_gap}")
    if n_exact != len(rels) or mism:
        raise AssertionError(f"the batched step's rows are not the single-row step's: "
                             f"{len(rels) - n_exact} of {len(rels)} differ, {mism} tokens")

    # where a step's time goes: the host's enqueue against the device
    pos = [p + STEP_BATCH_STEPS for p in pos0]
    pd = torch.tensor(pos, dtype=torch.int32, device="cuda")
    x = dec["token_embd"][toks]

    def batched():
        return dmod.decode_step_batch(dec, dcfg, x, cache, pd, pos)

    def serial():
        for b, p in enumerate(pos):
            dmod.decoder_forward(dec, dcfg, x[b:b + 1], singles[b], p + 1, prefill=False,
                                 cache_offset=p)

    out = {"rel_max": max(rels), "bit_equal": n_exact, "rows": len(rels)}
    for label, fn in (("batched", batched), ("8 single", serial)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enq = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        pwall, kernels = profiled(fn)
        busy = sum(k[0] for k in kernels)
        split = {part: sum(k[0] for k in kernels if key(k[2]))
                 for part, key in (("q8_body_ms", lambda n: "q8_rows" in n),
                                   ("k4_ms", lambda n: "dattn_" in n))}
        split["rest_ms"] = busy - sum(split.values())
        out[label] = {"wall_ms": wall, "enqueue_ms": enq, "busy_ms": busy,
                      "kernels": sum(k[1] for k in kernels), **split}
        log(f"  {label} step ({kv} KV): wall {wall:.4f} ms, enqueue {enq:.4f} ms, device "
            f"busy {busy:.4f} ms (Q8_0 body {split['q8_body_ms']:.4f}, K4 "
            f"{split['k4_ms']:.4f}, the rest {split['rest_ms']:.4f}; profiled wall "
            f"{pwall:.4f} ms, {out[label]['kernels']} kernels); top: "
            + "; ".join(f"{name[:48]} {ms:.3f} ms x{n}" for ms, n, name in kernels[:5]))
    return out


def batch_launches(quantize, L: int, B: int, P: int, steps: int, groups) -> dict:
    """Launch counts of one transcribe_batch, from the code: the batched
    prefill's 28 K2 and 18 per batched encoder call; per decode step K3
    bf16 once (a decode pack over bf16) or K4 batched 28 times, with Q8_0
    weights 29 K6 (28 QKV + the head over B rows), 28 K5 and 28 K7; the
    first tokens' head (K6) once; the prefill's products at B * P > 256
    rows are no kernel (Q8_0 wrappers' own path); the prefill is fused on
    auto's int8pc leaves."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig

    want = dict(no_launches(), flash=L * len(groups)
                + ASRModelConfig().encoder.n_layers * encoder_calls(groups),
                **prefill_want(len(groups), quantize == "auto", L))
    if quantize == "auto":
        want.update(mega_batch_bf16=steps)
        return want
    want.update(decode_attention_batch=L * steps)
    if quantize:
        small = L if B * P <= 256 else 0
        want.update(q8_norm_matmul=(L + 1) * steps + 1 + small,
                    q8_matmul=L * steps + small, q8_mlp=L * steps + small)
    return want


def phase_batch_requests(models: dict) -> dict:
    """transcribe_batch of BATCH_REQUESTS (mixed lengths, one batch, each in
    its own mel bucket; BATCH_TOKENS tokens, EOS off) in each mode of
    BATCH_MODES, each batch a window checked against batch_launches; every
    row's first BATCH_TWIN_TOKENS tokens against the twins teacher-forced on
    that row's request (near-tie rule); the same requests one at a time through transcribe (same params): auto +
    bf16 rows must equal them outright (K3 rows are K1 rows, the batched
    prefill's rows the single one's), the per-layer modes' equal rows are
    counted. Decode ms/step: (a 64-token run - a 1-token run) / 63, batched
    against the serial sum. -> {mode: readings}."""
    import torch

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams

    audio = [pcm(sec, 40 + i) for i, sec in enumerate(BATCH_REQUESTS)]
    groups = [audio]
    out = {}
    for quantize, kv in BATCH_MODES:
        asr = models[(quantize, kv)]
        L, V = asr.cfg.decoder.n_layers, asr.cfg.decoder.vocab_size

        def params(n):
            return TranscribeParams(max_tokens=n, mel_bucket=ENGINE_KW["mel_bucket"],
                                    print_timing=False)

        asr.transcribe_batch(audio[-1:], params(2))   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = asr.transcribe_batch(audio, params(BATCH_TOKENS))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        label = f"transcribe_batch {quantize or 'none'} + {kv} KV"
        got = window(label, 8 if quantize == "auto" else None, counts())
        P = -(-max(prompt_rows(sec) for sec in BATCH_REQUESTS) // 128) * 128
        want = batch_launches(quantize, L, len(audio), P, BATCH_TOKENS - 1, groups)
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for k, r in enumerate(res):
            if not r.success or len(r.tokens) != BATCH_TOKENS or not all(
                    0 <= t < V for t in r.tokens):
                raise AssertionError(f"{label}: request {k}: {len(r.tokens)} tokens or "
                                     f"one out of range")
        t0 = time.perf_counter()
        asr.transcribe_batch(audio, params(1))
        torch.cuda.synchronize()
        ms1 = (time.perf_counter() - t0) * 1e3
        singles, serial, serial1 = [], 0.0, 0.0
        for a in audio:
            t0 = time.perf_counter()
            singles.append(asr.transcribe(a, params(BATCH_TOKENS)).tokens)
            torch.cuda.synchronize()
            serial += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            asr.transcribe(a, params(1))
            torch.cuda.synchronize()
            serial1 += (time.perf_counter() - t0) * 1e3
        n_same = sum(r.tokens == s for r, s in zip(res, singles))
        step_ms = (ms - ms1) / (BATCH_TOKENS - 1)
        serial_step = (serial - serial1) / (BATCH_TOKENS - 1)
        log(f"{label}: {ms:.1f} ms for {len(audio)} x {BATCH_TOKENS} tokens (1 token "
            f"{ms1:.1f}); decode {step_ms:.4f} ms/step against {serial_step:.4f} ms for the "
            f"same {len(audio)} requests one at a time ({serial_step / step_ms:.2f}x the "
            f"tokens/s); rows equal to transcribe's: {n_same}/{len(audio)}; launches {got}")
        if quantize == "auto" and n_same != len(audio):
            raise AssertionError(f"{label}: rows differ from each request's transcribe")
        for a, r in zip(audio, res):
            check_tokens_vs_twins(asr, a, r.tokens[:BATCH_TWIN_TOKENS],
                                  mel_bucket=ENGINE_KW["mel_bucket"])
        out[label] = {"ms": ms, "ms_1_token": ms1, "decode_ms_step": step_ms,
                      "serial_decode_ms_step": serial_step, "rows_equal_single": n_same}
    return out


def phase_server_batches(models: dict) -> dict:
    """ASRServer with closed batches behind serve_http, --kv-cache bf16 (auto
    weights: K3 bf16) and --quantize q8_0 (its int8 cache: the per-layer
    step at B rows): 4 WAVs posted at once answer 200 with text, in one
    transcribe_batch of 4, a window whose K3 bf16 launches are the steps
    and K4 batched launches 28 x the steps (not 4x: no request runs
    alone). -> {label: launch counts}."""
    import json
    import threading
    import urllib.request

    import torch

    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
    from qwen3_asr_tpu_torch.serve import ASRServer, serve_http

    out = {}
    for label, asr, wbits in (("--kv-cache bf16", like(models[("auto", "bf16")], "bf16"), 8),
                              ("--quantize q8_0", like(models[("q8_0", "bf16")], "int8"),
                               None)):
        params = TranscribeParams(max_tokens=BATCH_TOKENS, mel_bucket=ENGINE_KW["mel_bucket"],
                                  print_timing=False)
        calls = []
        run = asr.transcribe_batch

        def recording(audios, p, run=run, calls=calls):
            calls.append(len(audios))
            return run(audios, p)

        asr.transcribe_batch = recording
        server = ASRServer(asr, params, max_batch=4, max_wait_ms=5000)
        httpd = serve_http(server, "127.0.0.1", 0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        replies = [None] * len(BATCH_REQUESTS)

        def one(i, sec, base=base, replies=replies):
            req = urllib.request.Request(base + "/v1/transcribe",
                                         data=wav_bytes(pcm(sec, 50 + i)),
                                         headers={"Content-Type": "audio/wav"})
            with urllib.request.urlopen(req, timeout=600) as r:
                replies[i] = (r.status, json.loads(r.read()))

        try:
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i, sec))
                       for i, sec in enumerate(BATCH_REQUESTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            got = window(f"server {label}", wbits, counts())
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        L, steps = asr.cfg.decoder.n_layers, BATCH_TOKENS - 1
        key, want = (("mega_batch_bf16", steps) if wbits else ("decode_attention_batch",
                                                                L * steps))
        prefill = prefill_want(1, wbits is not None, L)
        moved = {k: got[k] for k in set(prefill) | {"fused_layers", "eager_layers",
                                                    *PREFILL_PASSES}}
        log(f"phase server {label}: codes {[r and r[0] for r in replies]}, "
            f"transcribe_batch calls {calls}, wall {wall:.1f} ms; launches {got}")
        if any(r is None or r[0] != 200 or "text" not in r[1] for r in replies):
            raise AssertionError(f"server {label}: a request was not answered 200 with text")
        if calls != [len(BATCH_REQUESTS)] or got[key] != want or got["decode_attention"] \
                or got["mega"] or got["mega_bf16"] or moved != dict.fromkeys(moved, 0) | prefill:
            raise AssertionError(f"server {label}: transcribe_batch calls {calls}, "
                                 f"{key} {got[key]} (want {want}), prefill {moved} (want "
                                 f"{prefill}), launches {got}")
        out[label] = got
    return out


def phase_batch_modes(q8, auto) -> dict:
    """Batches in every mode (on the q8_0 model and the auto model of the
    earlier phases, and a dense one loaded here): K4 batched, K3 over a
    bf16 cache (the int8 pack), the per-layer step at B rows on both caches,
    transcribe_batch in BATCH_MODES and the server's closed batches. ->
    the readings."""
    import torch

    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    t_phase = time.perf_counter()
    dcfg = auto.cfg.decoder
    out = {"k4": phase_decode_attention_batch(dcfg),
           "k3_bf16": phase_mega_batch(dcfg, auto.params["decoder"]["mega"], "bf16"),
           "step": {kv: phase_step_batch(q8, kv) for kv in ("bf16", "int8")}}
    dense = Qwen3ASR(quantize=False, kv_cache="bf16", device="cuda")
    dense.load_random(ASRModelConfig(), seed=0)
    eos_off(dense)
    models = {("q8_0", "bf16"): like(q8, "bf16"), ("q8_0", "int8"): like(q8, "int8"),
              (False, "bf16"): dense, ("auto", "bf16"): like(auto, "bf16")}
    out["requests"] = phase_batch_requests(models)
    out["server"] = phase_server_batches(models)
    del dense, models
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase batch modes: {out['seconds']:.1f} s")
    return out


# -- the MoE thinker (Qwen3-Omni-30B-A3B's) ---------------------------------------

MOE_LAYERS = 8                   # the thinker's widths, fewer layers
MOE_REQUESTS = ((5, 18), (30, 105))   # the cell's shortest and longest


def moe_prefill_want(n: int, L: int) -> dict:
    """What n MoE prefills of L layers add to a window's counts: L fused
    layers a prefill; norm_quant_rows 2 L + 1 (layer 0's norm, each
    attention output and each layer's SwiGLU rows), qkv_epilogue L and
    residual_norm_quant L (the attention's); a layer's router, grouped
    gate-up and down and residual pass; no swiglu_quant."""
    return {"fused_layers": n * L, "norm_quant_rows": (2 * L + 1) * n, "qkv_epilogue": L * n,
            "residual_norm_quant": L * n, "route": L * n, "moe_gate_up": L * n,
            "moe_down": L * n, "moe_combine": L * n}


def moe_thinker(L: int = MOE_LAYERS):
    """Qwen3-Omni-30B-A3B's thinker at its published widths with L decoder
    layers (random weights, EOS off, int8pc, bf16 cache)."""
    import torch

    from qwen3_asr_tpu_torch.config import ASRModelConfig, AudioEncoderConfig, MoeDecoderConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    cfg = ASRModelConfig(
        encoder=AudioEncoderConfig(n_layers=32, d_model=1280, n_heads=20, ffn_dim=5120,
                                   output_dim=2048, n_window_infer=800),
        decoder=MoeDecoderConfig(vocab_size=152064, hidden_size=2048, n_layers=L, n_heads=32,
                                 n_kv_heads=4, head_dim=128, intermediate_size=768,
                                 audio_pad_token_id=151675, eos_token_id=-1))
    asr = Qwen3ASR(quantize="int8pc", kv_cache="bf16", device="cuda")
    asr.load_random(cfg, seed=3)
    torch.cuda.synchronize()
    return asr


def phase_moe_prefill(dec, dcfg) -> dict:
    """The prefill's router and grouped products at a 5 s and a 30 s
    prompt's rows (80, 410) on layer 0's experts, against their twins on
    the same inputs: the SwiGLU rows, their codes (F1) and the weighted
    slots bit-equal, the residual pass's rows bit-equal and its codes
    within one; ms (graph of 20), bound (the touched experts' bytes at 3.35
    TB/s, or the pairs' int8 operations)."""
    import torch

    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops import prefill_fused as pf
    from qwen3_asr_tpu_torch.ops.prefill_fused import codes_buffer

    H, F, E, K = dcfg.hidden_size, dcfg.moe_intermediate_size, dcfg.n_experts, dcfg.n_experts_per_tok
    lay = dec["layers"]
    gu, dn = ({k: v[0] for k, v in lay[n].items()} for n in ("experts_gu", "experts_down"))
    g = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    cpu = (lambda t: t.cpu())
    for N in (80, 410):
        codes = codes_buffer(N, H, "cuda")
        codes[:N] = torch.randint(-127, 128, (N, H), generator=g, device="cuda",
                                  dtype=torch.int8)
        sx = torch.rand(N, 1, generator=g, device="cuda") * 0.01 + 1e-3
        res = (torch.randn(N, H, generator=g, device="cuda") * 3).to(torch.bfloat16)
        wts, order, off = moe.route(codes, sx, lay["router"][0], K)
        rw, ro, rf = moe.route_ref(*map(cpu, (codes, sx, lay["router"][0])), K)
        work = moe.prefill_work(N, H, F, K, "cuda")
        act = moe.moe_gate_up(codes, sx, order, off, gu["q"], gu["s"], K, work)
        pf.norm_quant_rows(act, None, dcfg.rms_norm_eps, work["fq"], work["fs"])
        fq, fs = work["fq"], work["fs"]
        ys = moe.moe_down(fq, fs, order, off, wts, dn["q"], dn["s"], work)
        oc, osx = codes_buffer(N, H, "cuda"), torch.empty(N, 1, device="cuda")
        x = moe.moe_combine(res, ys, K, lay["attn_norm"][1 % dcfg.n_layers], dcfg.rms_norm_eps,
                            oc, osx)
        torch.cuda.synchronize()
        cw = moe.prefill_work(N, H, F, K, "cpu")
        args = (cpu(codes), cpu(sx), cpu(order), cpu(off))
        ract = moe.moe_gate_up_ref(*args, cpu(gu["q"]), cpu(gu["s"]), K, cw)
        pf.norm_quant_rows_ref(ract, None, dcfg.rms_norm_eps, cw["fq"], cw["fs"])
        rq, rs = cw["fq"], cw["fs"]
        rys = moe.moe_down_ref(rq, rs, cpu(order), cpu(off), cpu(wts), cpu(dn["q"]),
                               cpu(dn["s"]), cw)
        rc, rsx = codes_buffer(N, H, "cpu"), torch.empty(N, 1)
        rx = moe.moe_combine_ref(cpu(res), cpu(ys), K, cpu(lay["attn_norm"][1 % dcfg.n_layers]),
                                 dcfg.rms_norm_eps, rc, rsx)
        counts = torch.diff(off).cpu()
        if not torch.equal(counts, torch.diff(rf)):
            raise AssertionError(f"moe route N {N}: expert counts differ from the twin's")
        if not torch.equal(act.cpu(), ract):
            raise AssertionError(f"moe_gate_up N {N}: SwiGLU rows differ from the twin's")
        if not (torch.equal(fq.cpu(), rq) and torch.equal(fs.cpu(), rs)):
            raise AssertionError(f"moe_gate_up N {N}: the rows' codes differ from the twin's")
        if not torch.equal(ys.cpu(), rys):
            raise AssertionError(f"moe_down N {N}: slots differ from the twin's")
        code_err = int((oc[:N].cpu().int() - rc[:N].int()).abs().max())
        if not torch.equal(x.cpu(), rx) or code_err > 1:
            raise AssertionError(f"moe_combine N {N}: rows or codes ({code_err}) off")
        if list(work["stats"].cpu()) != [int((counts > 0).sum()), int(counts.max())]:
            raise AssertionError(f"moe_gate_up N {N}: counters {work['stats'].tolist()}")
        touched, pairs = int((counts > 0).sum()), N * K
        eb_gu, eb_dn = 2 * F * H + 8 * F, F * H + 4 * H
        ms = {"route": graph_ms(lambda: moe.route(codes, sx, lay["router"][0], K)),
              "moe_gate_up": graph_ms(lambda: moe.moe_gate_up(codes, sx, order, off, gu["q"],
                                                              gu["s"], K, work)),
              "norm_quant_rows": graph_ms(lambda: pf.norm_quant_rows(
                  act, None, dcfg.rms_norm_eps, fq, fs)),
              "moe_down": graph_ms(lambda: moe.moe_down(fq, fs, order, off, wts, dn["q"],
                                                        dn["s"], work)),
              "moe_combine": graph_ms(lambda: moe.moe_combine(res, ys, K,
                                                              lay["attn_norm"][0],
                                                              dcfg.rms_norm_eps, oc, osx))}
        b = {"route": bound(N * H + H * E * 2, 2.0 * N * H * E, BF16_FLOPS),
             "moe_gate_up": bound(touched * eb_gu + N * H, 2.0 * pairs * 2 * F * H, INT8_OPS),
             "norm_quant_rows": bound(pairs * F * 3, 0.0, BF16_FLOPS),
             "moe_down": bound(touched * eb_dn + pairs * (F + 4 * H), 2.0 * pairs * F * H,
                               INT8_OPS),
             "moe_combine": bound(pairs * H * 4 + N * H * 5, 0.0, BF16_FLOPS)}
        for name in ms:
            out[(name, N)] = (code_err if name == "moe_combine" else 0.0, ms[name], None,
                              *b[name])
        log(f"moe prefill N {N} ({touched} experts, {pairs} pairs): " + ", ".join(
            f"{n} {ms[n]:.4f} ms (bound {b[n][0]:.4f} {b[n][1]})" for n in ms)
            + f"; the combine's codes within {code_err} of the twin's")
    return out


def moe_digest(step, tokens) -> str:
    """The first 16 hex digits of the sha256 of a step's tokens and of its
    h_out after each of them: a graphed MoE step (`GraphStep`) run over
    tokens[0] .. at positions 200 ..; tokens int32 [n] on the device, its
    entries past the first overwritten with the decoded ones."""
    import hashlib

    import torch

    hs = []
    for i in range(1, tokens.shape[0]):
        step(tokens, i, 200 + i - 1)
        hs.append(step.h.clone())
    torch.cuda.synchronize()
    blob = tokens.cpu().numpy().tobytes() + torch.cat(hs).cpu().numpy().tobytes()
    return hashlib.sha256(blob).hexdigest()[:16]


def phase_moe_step(dec, dcfg) -> dict:
    """The MoE decode step on the thinker's layers: each layer alone against
    the twin on the same input row and cache (h within 1e-2; the routed
    experts logged), 32 graphed steps bit-equal to 32 eager ones (tokens and
    caches) and their digest (`moe_digest`), kernel launches a step, the
    persistent attention launch's blocks, and ms/step graphed (its bound:
    the attention's weights, 8 experts and the router a layer, the head,
    the cache)."""
    import dataclasses

    import torch

    from qwen3_asr_tpu_torch.ops import moe
    from qwen3_asr_tpu_torch.ops.megakernel import GraphStep
    from qwen3_asr_tpu_torch.ops.support import kernels_a_call

    pack, L, S = dec["moe"], dcfg.n_layers, 1024
    DKV = dcfg.n_kv_heads * dcfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(11)
    k0 = (torch.randn(L, S, DKV, generator=g, device="cuda") * 2).to(torch.bfloat16)
    v0 = (torch.randn(L, S, DKV, generator=g, device="cuda") * 2).to(torch.bfloat16)
    pos, tok = 300, torch.tensor([1234], dtype=torch.int32, device="cuda")
    step = moe.MoeDecodeStep(pack, dcfg, k0.clone(), v0.clone())
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    step.pos.fill_(pos)
    n_k = kernels_a_call(lambda: step(tok, step.pos, out))
    if n_k != moe.step_kernels(L) or n_k != 4 * L + 4:
        raise AssertionError(f"MoE step: {n_k} kernels, want {moe.step_kernels(L)}")
    worst = 0.0
    c1 = dataclasses.replace(dcfg, n_layers=1)
    for l in range(L):   # one layer alone, on the twin's input
        one = {k: (v[l:l + 1] if k not in ("head_q", "head_s", "out_norm", "embd") else v)
               for k, v in pack.items()}
        kk, vv = k0[l:l + 1].clone(), v0[l:l + 1].clone()
        x = (torch.randn(1, dcfg.hidden_size, generator=g, device="cuda") * 3).to(torch.bfloat16)
        s1 = moe.MoeDecodeStep(one, c1, kk, vv)
        s1(x, pos, out)
        ids = s1.ids.clone()
        _, rh = moe.moe_decode_step_ref(one, c1, x, pos, k0[l:l + 1].clone(),
                                        v0[l:l + 1].clone())
        rel = float((s1.h - rh).norm() / rh.norm())
        worst = max(worst, rel)
        log(f"MoE step layer {l} alone: h rel {rel:.3g}, experts {ids.tolist()}")
        if rel > 1e-2:
            raise AssertionError(f"MoE step layer {l}: h rel {rel}")
    ka, va, kb, vb = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    e = moe.MoeDecodeStep(pack, dcfg, ka, va)
    o1 = torch.zeros(33, dtype=torch.int32, device="cuda")
    o1[0] = 77
    for i in range(1, 33):
        e(o1[i - 1:i], 200 + i - 1, o1[i:i + 1])
    gs = GraphStep(moe.MoeDecodeStep(pack, dcfg, kb, vb))
    o2 = torch.zeros(33, dtype=torch.int32, device="cuda")
    o2[0] = 77
    digest = moe_digest(gs, o2)
    if not (torch.equal(o1, o2) and torch.equal(ka, kb) and torch.equal(va, vb)):
        raise AssertionError("MoE step: 32 graphed steps differ from 32 eager ones")
    o3 = torch.zeros(130, dtype=torch.int32, device="cuda")
    gt = GraphStep(moe.MoeDecodeStep(pack, dcfg, k0.clone(), v0.clone()))
    gt(o3, 1, pos)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for i in range(2, 130):
        gt(o3, i, pos + i - 1)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 128
    H, F, K, E, V = (dcfg.hidden_size, dcfg.moe_intermediate_size, dcfg.n_experts_per_tok,
                     dcfg.n_experts, dcfg.vocab_size)
    DQ = dcfg.n_heads * dcfg.head_dim
    nbytes = (L * (H * (DQ + 2 * DKV) + DQ * H + 4 * (DQ + 2 * DKV + H) + 2 * H * E
                   + K * (3 * H * F + 4 * (2 * F + H)))
              + H * V + 4 * V + L * (pos + 64) * DKV * 2 * 2)
    b = bound(nbytes, 0.0, INT8_OPS)
    log(f"MoE step: {n_k} kernels a step at {L} layers, moe_attn_layer on {step.attn_blocks} "
        f"blocks, graphed {ms:.4f} ms/step at pos {pos}-{pos + 128} (bound {b[0]:.4f} "
        f"{b[1]}); layers alone h rel <= {worst:.3g}; 32 graphed steps == eager, digest "
        f"{digest}")
    return {"err": worst, "ms": ms, "bound": b, "kernels": n_k, "attn_blocks": step.attn_blocks,
            "digest": digest}


def phase_moe():
    """Qwen3-Omni-30B-A3B's thinker at its published widths with MOE_LAYERS
    decoder layers: the prefill's products and the decode step against their
    twins (phase_moe_prefill, phase_moe_step), then the CLI's transcription
    (fused) of the cell's shortest and longest request, its launches a
    window (the prefills' passes and products, one MoE step a token) and its
    decode ms/step."""
    import torch

    asr = moe_thinker()
    dec, dcfg = asr.params["decoder"], asr.cfg.decoder
    prefill = phase_moe_prefill(dec, dcfg)
    step = phase_moe_step(dec, dcfg)
    asr.transcribe(pcm(5, 1), tparams(8))   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    times = []
    for seconds, max_tokens in MOE_REQUESTS:
        t0 = time.perf_counter()
        r = asr.transcribe(pcm(seconds), tparams(max_tokens))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if len(r.tokens) != max_tokens or not all(0 <= t < dcfg.vocab_size for t in r.tokens):
            raise AssertionError(f"MoE {seconds} s: {len(r.tokens)} tokens or one out of range")
    got = window("MoE thinker (int8pc, bf16 KV)", None, counts())
    n, L = len(MOE_REQUESTS), dcfg.n_layers
    want = dict(no_launches(), flash=L * n,
                moe_decode_step=sum(mt - 1 for _, mt in MOE_REQUESTS), **moe_prefill_want(n, L))
    log(f"MoE requests {[f'{t:.1f} ms' for t in times]} at {L} layers; launches {got}")
    if got != want:
        raise AssertionError(f"MoE launch counts {got} (want {want})")
    del asr
    return prefill, step, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.models import generate as gen_mod
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_cuda_kernels
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR
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
    has_cuda_kernels.cache_clear()
    has_cuda_kernels.launches = 0
    if not has_cuda_kernels():
        raise RuntimeError("the kernel library's probe failed on this device")
    k8_launches = has_cuda_kernels.launches   # the start-up path: one a process

    f_c = phase_flash(True, 1280, 16, 8, 128, [1216])
    f_b = phase_flash(False, 1196, 14, 14, 64, [1196])
    f_cb = phase_flash(True, 1280, 16, 8, 128, [1216, 904, 512, 77])
    f_bb = phase_flash(False, 1235, 14, 14, 64, [1235, 1196, 650, 130])
    # the aligner's NAR pass: a 2,845-row prompt bucketed to 2,944, and a
    # batch of four prompts of different lengths in that bucket
    f_ac = phase_flash(True, 2944, 16, 8, 128, [2845])
    f_acb = phase_flash(True, 2944, 16, 8, 128, [2845, 1900, 950, 300])
    k8 = phase_probe()
    da_ms = phase_decode_attention(ASRModelConfig().decoder, 1248, 1664)

    t0 = time.perf_counter()
    asr = Qwen3ASR(quantize="int4", kv_cache="int8", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    torch.cuda.synchronize()
    log(f"load_random + int8pc + int4 pack: {time.perf_counter() - t0:.1f} s")
    eos_off(asr)
    m = phase_mega(asr.cfg, asr.params["decoder"])
    m4b = phase_mega(asr.cfg, asr.params["decoder"], "bf16", steps=16, floor_steps=0)
    m4i4 = phase_mega(asr.cfg, asr.params["decoder"], "int4", steps=16)

    caches = []
    make_cache = gen_mod.init_kv_cache

    def recording_cache(*a, **k):
        c = make_cache(*a, **k)
        caches.append(c)
        return c

    gen_mod.init_kv_cache = recording_cache
    asr.transcribe(pcm(5, 1), tparams(8))   # warm-up
    torch.cuda.synchronize()

    reset_counts()
    results = []
    for seconds, max_tokens in REQUESTS:
        t0 = time.perf_counter()
        r = asr.transcribe(pcm(seconds), tparams(max_tokens))
        torch.cuda.synchronize()
        results.append((seconds, max_tokens, (time.perf_counter() - t0) * 1e3, r))
    launches = window("int4 weights, int8 KV requests", 4, counts())
    gen_mod.init_kv_cache = make_cache
    for seconds, max_tokens, ms, r in results:
        log(f"request {seconds} s: {ms:.1f} ms, {len(r.tokens)} tokens "
            f"(max {max_tokens}), success={r.success}")

    # decode ms/step on the 92 s request: (323 tokens - 1 token) / 322 steps
    t0 = time.perf_counter()
    asr.transcribe(pcm(92), tparams(1))
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) * 1e3
    per_step = (results[-1][2] - one) / (REQUESTS[-1][1] - 1)
    log(f"92 s request with 1 token: {one:.1f} ms; decode {per_step:.4f} ms/step")

    # checks on the main path
    assert_on_device(asr.params, "cuda")
    for c in caches:
        assert_on_device(c, "cuda")
    want = dict(no_launches(), flash=asr.cfg.decoder.n_layers * len(REQUESTS),
                mega=sum(mt - 1 for _, mt in REQUESTS),
                **prefill_want(len(REQUESTS), True, asr.cfg.decoder.n_layers))
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
    phase_int4_bf16(asr)

    k3 = phase_mega_batch(asr.cfg.decoder, asr.params["decoder"]["mega"])

    gen_mod.init_kv_cache = recording_cache
    try:
        slice_launches_, q8_step_ms, q8_asr = phase_slice(caches)
    finally:
        gen_mod.init_kv_cache = make_cache
    window("per-layer path (q8_0, dense)", None, slice_launches_)
    for c in caches:
        assert_on_device(c, "cuda")
    p5 = prompt_rows(5)
    # T 4, 8 and 16: the per-layer step at B rows (a closed batch of 4, the
    # batched-step phase's 8, the widest batch); p5: a 5 s prompt's prefill
    q8k = phase_q8(q8_asr.params["decoder"], q8_asr.cfg.decoder, Q8_ROWS + (p5,))
    sampling = {"q8_0": phase_sampling(q8_asr, "q8_0", None, None, 64, 16)}

    # the JAX package's default weight mode: the int8 pack
    auto, auto_step, auto_stages = phase_auto()
    prefill_fused = phase_prefill_fused(auto)
    batch_modes = phase_batch_modes(q8_asr, auto)
    del q8_asr
    m8 = phase_mega(auto.cfg, auto.params["decoder"], "int8", steps=16, floor_steps=0)
    m8b = phase_mega(auto.cfg, auto.params["decoder"], "bf16", steps=16, floor_steps=0)
    k1_graph = phase_mega_graph(auto.cfg, auto.params["decoder"])
    m8i4 = phase_mega(auto.cfg, auto.params["decoder"], "int4", steps=16, floor_steps=0)
    # long context: K1 (int8 pack) at S 8,192 on each cache
    long_ctx = {kv: phase_mega(auto.cfg, auto.params["decoder"], kv, steps=4, floor_steps=0,
                               S=LONG_S, pos_end=LONG_POS, layers=False)
                for kv in ("int8", "bf16", "int4")}
    k3_8 = phase_mega_batch(auto.cfg.decoder, auto.params["decoder"]["mega"], trace=True)
    k3_product = phase_k3_product(auto.cfg.decoder, auto.params["decoder"]["mega"])
    server_step_ms = phase_server_default(auto)
    i4_step = phase_kv_int4(asr, auto)
    stream_ms = phase_streaming(asr, auto)
    phase_server_int4(auto)
    for label, model, wbits, key in (("auto", auto, 8, "mega_bf16"),
                                     ("int4", asr, 4, "mega"),
                                     ("int4 + int4 KV", like(asr, "int4"), 4, "mega_i4")):
        sampling[label] = phase_sampling(model, label, wbits, key, SPEC_TOKENS, 64)
    spec = phase_spec(auto, asr)
    phase_server_sampling(auto)
    phase_cli_sampling(auto)
    del auto

    engine_tps, engine_launches = phase_engine(asr)
    window("engine (int4 weights)", 4, engine_launches)
    window("HTTP (int4 weights)", 4, phase_http(asr))
    del asr
    _, align_stages = phase_aligner()
    moe_prefill, moe_step, _ = phase_moe()
    mb, mb_res, mb_lib = phase_microbench()
    total = {k: launches_of(k) for k in no_launches()}
    log(f"pool decode {engine_tps:.1f} tokens/s; server default closed batch of 4 decode "
        f"{server_step_ms:.4f} ms/step; q8_0 decode {q8_step_ms:.4f} "
        f"ms/step; auto decode {auto_step[True]:.4f} ms/step (staged "
        f"{auto_step[False]:.4f}); int4 + int4 KV decode {i4_step:.4f} ms/step; "
        f"streaming decode (vs generate_greedy, staged) " + ", ".join(
            f"{k} {a:.4f} ({b:.4f})" for k, (a, b) in stream_ms.items())
        + f"; launches over every checked window {total}; K8 probe {k8[1]:.4f} ms "
        f"(bound {k8[3]:.6f} ms, bytes)")
    log("sampled vs greedy decode ms/step: " + ", ".join(
        f"{k} {v['sampled_ms_step']:.4f} / {v['greedy_ms_step']:.4f} ({v['seconds']:.1f} s)"
        for k, v in sampling.items()) + "; spec ms per emitted token (acceptance): " + ", ".join(
        f"{lab} k={k} {v['ms_per_token']:.4f} ({v['accepted'] / v['drafted']:.1%})"
        for (lab, k), v in ((key, v) for key, v in spec.items() if key != "seconds"))
        + f"; phase spec {spec['seconds']:.1f} s")

    def per_request(mode, key):
        """The sampled request's launches of `key` (92 s / 323 tokens; q8_0:
        92 s / 64) and the mode's sampled and greedy ms/step."""
        return {"launches_per_sampled_request": sampling[mode]["launches"][key],
                "sampled_ms_step": sampling[mode]["sampled_ms_step"],
                "greedy_ms_step": sampling[mode]["greedy_ms_step"]}

    def row(name, src, replaces, launches, err, ms, plain, b_ms, b_by, lib=None, **extra):
        return {"name": name, "route": "cuda",
                "source": f"qwen3_asr_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "twin_ms": plain, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib, **extra}

    head = ("K6 q8_norm_matmul (lm head)", 1)

    def by_rows(*names):
        """K5-K7 at every T of phase_q8 (one row, the per-layer step's B rows,
        a 5 s prompt's rows). The parent's times beside them are in PERF.md,
        measured in one call with these by chip_compare.py."""
        return {f"{n} T={T}": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by"), q8k[(n, T)]))
                for n in names for T in Q8_ROWS + (p5,)}

    k1 = "qwen3_asr_tpu/ops/megakernel.py:460"
    k4b = batch_modes["k4"]
    k3_src = "qwen3_asr_tpu/ops/megakernel_batch.py:110"
    gb = {mode: round(r["gb_s"], 1) for mode, r in mb_res.items()}
    kernels = [
        row("mega_decode_step_i8", "megakernel.cu", k1, launches_of("mega", 4), *m,
            **per_request("int4", "mega"),
            spec_ms_per_token={k: spec[("int4", k)]["ms_per_token"] for k in SPEC_KS},
            spec_tokens=SPEC_SHORT),
        row("mega_decode_step (int4 weights, bf16 KV)", "megakernel.cu", k1,
            launches_of("mega_bf16", 4), *m4b),
        row("mega_decode_step_i8 (int8 weights)", "megakernel.cu", k1,
            launches_of("mega", 8), *m8,
            launches_per_spec_request=spec[("auto", 4)]["launches"]["mega"],
            spec_ms_per_token={k: spec[("auto", k)]["ms_per_token"] for k in SPEC_KS},
            spec_acceptance={k: spec[("auto", k)]["accepted"] / spec[("auto", k)]["drafted"]
                             for k in SPEC_KS},
            s8192_ms=long_ctx["int8"][1], s8192_bound_ms=long_ctx["int8"][3]),
        row("mega_decode_step (int8 weights, bf16 KV)", "megakernel.cu", k1,
            launches_of("mega_bf16", 8), *m8b, **per_request("auto", "mega_bf16"),
            s8192_ms=long_ctx["bf16"][1], s8192_bound_ms=long_ctx["bf16"][3],
            step_ms={f"{'graphed' if g else 'eager'}_pdl_{'on' if p else 'off'}": t[0]
                     for (g, p), t in k1_graph.items()},
            enqueue_ms={f"{'graphed' if g else 'eager'}_pdl_{'on' if p else 'off'}": t[1]
                        for (g, p), t in k1_graph.items()}),
        row("mega_decode_step_i4 (int4 weights, int4 KV)", "megakernel.cu",
            "qwen3_asr_tpu/ops/megakernel.py:1520", launches_of("mega_i4", 4), *m4i4,
            **per_request("int4 + int4 KV", "mega_i4")),
        row("mega_decode_step_i4 (int8 weights, int4 KV)", "megakernel.cu",
            "qwen3_asr_tpu/ops/megakernel.py:1520", launches_of("mega_i4", 8), *m8i4,
            s8192_ms=long_ctx["int4"][1], s8192_bound_ms=long_ctx["int4"][3]),
        row("flash_attention", "flash_attention.cu",
            "qwen3_asr_tpu/ops/pallas_attention.py:32", total["flash"],
            max(f[0] for f in (f_c, f_b, f_cb, f_bb, f_ac, f_acb)), f_c[1], f_c[2],
            f_c[4], f_c[5], lib=f_c[3],
            aligner_t2944={"ms": f_ac[1], "plain_ms": f_ac[2], "library_ms": f_ac[3],
                           "bound_ms": f_ac[4], "bound_by": f_ac[5]},
            aligner_t2944_b4={"ms": f_acb[1], "plain_ms": f_acb[2], "library_ms": f_acb[3],
                              "bound_ms": f_acb[4], "bound_by": f_acb[5]},
            launches_per_alignment=launches_of_label("aligner staged", "flash"),
            launches_per_sampled_request=sampling["auto"]["launches"]["flash"],
            launches_per_spec_request=spec[("auto", 4)]["launches"]["flash"]),
        row("mega_decode_step_batch", "megakernel_batch.cu", k3_src,
            launches_of("mega_batch", 4), *k3[:5], **k3[5]),
        row("mega_decode_step_batch (int8 weights)", "megakernel_batch.cu", k3_src,
            launches_of("mega_batch", 8), *k3_8[:5], **k3_8[5],
            product_alone={f"{shape} B={B}": {"ms": v[0], "library_ms": v[1],
                                              "bound_ms": v[2], "bound_by": v[3]}
                           for (shape, B), v in k3_product.items()}),
        row("mega_decode_step_batch (int8 weights, bf16 KV)", "megakernel_batch.cu", k3_src,
            launches_of("mega_batch_bf16", 8), *batch_modes["k3_bf16"][:5],
            **batch_modes["k3_bf16"][5],
            launches_per_batch_of_4=launches_of_label("server --kv-cache bf16",
                                                      "mega_batch_bf16")),
        row("decode_attention", "decode_attention.cu",
            "qwen3_asr_tpu/ops/decode_attention.py:65", total["decode_attention"],
            max(v[0] for v in da_ms.values()), *da_ms[("bf16", 1248)][1:],
            int8={"ms": da_ms[("int8", 1248)][1], "plain_ms": da_ms[("int8", 1248)][2],
                  "bound_ms": da_ms[("int8", 1248)][3]},
            launches_per_sampled_request=sampling["q8_0"]["launches"]["decode_attention"]),
        row("decode_attention_batch (K4, B rows)", "decode_attention.cu",
            "qwen3_asr_tpu/ops/decode_attention.py:65", total["decode_attention_batch"],
            max(v[0] for v in k4b.values()), *k4b["bf16"][1:5],
            one_row_x8_ms=k4b["bf16"][5],
            int8={"ms": k4b["int8"][1], "plain_ms": k4b["int8"][2],
                  "bound_ms": k4b["int8"][3], "one_row_x8_ms": k4b["int8"][5]},
            launches_per_batch_of_4=launches_of_label("server --quantize q8_0",
                                                      "decode_attention_batch")),
        row("q8_matmul", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:69",
            total["q8_matmul"], max(v[0] for k, v in q8k.items() if k[0].startswith("K5")),
            *q8k[("K5 q8_matmul (Wo)", 1)][1:], by_rows=by_rows("K5 q8_matmul (Wo)"),
            launches_per_sampled_request=sampling["q8_0"]["launches"]["q8_matmul"]),
        row("q8_norm_matmul", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:173",
            total["q8_norm_matmul"],
            max(v[0] for k, v in q8k.items() if k[0].startswith("K6")), *q8k[head][1:],
            by_rows=by_rows("K6 q8_norm_matmul (QKV)", "K6 q8_norm_matmul (lm head)"),
            launches_per_sampled_request=sampling["q8_0"]["launches"]["q8_norm_matmul"]),
        row("q8_mlp", "q8_matmul.cu", "qwen3_asr_tpu/ops/q8_matmul.py:224",
            total["q8_mlp"], max(v[0] for k, v in q8k.items() if k[0].startswith("K7")),
            *q8k[("K7 q8_mlp", 1)][1:], by_rows=by_rows("K7 q8_mlp"),
            launches_per_sampled_request=sampling["q8_0"]["launches"]["q8_mlp"]),
        *(row(name, "prefill_fused.cu", "none: XLA fuses these ops in the JAX package",
              launches_of(name.split()[0]),
              max(v[0] for v in prefill_fused["passes"][name].values()),
              *prefill_fused["passes"][name]["B1xP1280"][1:],
              by_shape={s: dict(zip(("codes_moved", "ms", "plain_ms", "bound_ms",
                                     "bound_by"), v))
                        for s, v in prefill_fused["passes"][name].items()},
              prefill=prefill_fused["prefill"])
          for name in prefill_fused["passes"]),
        *(row(name, "moe.cu" if name != "moe_combine" else "prefill_fused.cu",
              "none: the JAX package has no mixture-of-experts model",
              launches_of(name), *moe_prefill[(name, 410)],
              by_rows={f"N={N}": dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by"), moe_prefill[(name, N)]))
                       for N in (80, 410)})
          for name in ("route", "moe_gate_up", "moe_down", "moe_combine")),
        row("moe_decode_step (MoE thinker step)", "moe.cu",
            "none: the JAX package has no mixture-of-experts model",
            launches_of("moe_decode_step"), moe_step["err"], moe_step["ms"], None,
            *moe_step["bound"], kernels_a_step=moe_step["kernels"],
            attn_blocks=moe_step["attn_blocks"], digest=moe_step["digest"],
            layers=MOE_LAYERS),
        row("probe (K8, y = 2 x)", "probe.cu", "qwen3_asr_tpu/ops/support.py:35",
            k8_launches, *k8, "bytes", lib=k8[2]),
        row("stream_read (K9 read)", "microbench_stream.cu",
            "scripts/microbench_stream.py:39", total["mb_read"], *mb["read"],
            lib=mb_lib, gb_s=gb["read"]),
        row("stream_read_ring (K9 read, cp.async ring)", "microbench_stream.cu",
            "scripts/microbench_stream.py:39", total["mb_read_ring"], *mb["read_ring"],
            lib=mb_lib, gb_s=gb["read_ring"]),
        row("stream_gemv (K9 int8_m1; int8_m8, bf16_m8)", "microbench_stream.cu",
            "scripts/microbench_stream.py:39", total["mb_gemv"],
            max(mb[m][0] for m in ("int8_m1", "int8_m8", "bf16_m8")), *mb["int8_m1"][1:],
            gb_s=gb["int8_m1"], modes={m: {"ms": mb[m][1], "plain_ms": mb[m][2],
                                           "bound_ms": mb[m][3], "gb_s": gb[m]}
                                       for m in ("int8_m8", "bf16_m8")}),
        row("stream_gemv_i4 (K10 int4_m1)", "microbench_stream.cu",
            "scripts/probe_int4.py:138", total["mb_gemv_i4"], *mb["int4_m1"],
            gb_s=gb["int4_m1"]),
        row("unpack_probe (K11 nibble order)", "microbench_stream.cu",
            "scripts/probe_int4b.py:58", total["mb_unpack"], *mb["unpack_nibbles"],
            gb_s=gb["unpack_nibbles"]),
    ]
    log("batched decode ms/step against the same requests one at a time: " + ", ".join(
        f"{k} {v['decode_ms_step']:.4f} / {v['serial_decode_ms_step']:.4f}"
        for k, v in batch_modes["requests"].items())
        + f"; phase batch modes {batch_modes['seconds']:.1f} s")
    missing = [k["name"] for k in kernels if not k["launches"]]
    if missing:
        raise AssertionError(f"kernels launched no time on their paths: {missing}")
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
