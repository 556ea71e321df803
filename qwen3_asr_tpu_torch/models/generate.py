"""Generation: the prefill, then the decode loop, for one sequence or a
batch in lockstep (on the decode pack or the per-layer step), greedy,
sampled or self-speculative; and the aligner's one non-autoregressive pass
(`nar_forward`, `nar_forward_batch`).

Port of qwen3_asr_tpu/models/generate.py:36-462 (`generate_greedy`,
`prefill_only`, the streaming path `generate_greedy_streaming` with its
`decode_chunk*` functions), of `prefill_batch_mega_cache` /
`generate_greedy_batch_mega` (:465-578), the batched path, of
`generate_greedy_spec` (:606-737), greedy self-speculation, and of
`sample_from_logits` / `generate_sample` (:755-967), sampled decoding;
`generate_greedy_batch` is `generate_greedy` under the reference's
`jax.vmap` (parallel/mesh.py:318-329), written out over B rows. The branch
follows what the tree holds, as in the reference: a decode pack (`"mega"`,
int4 or int8 weights) runs each step through the decode megakernel, its
entry picked by the cache dtype (`mega_decode_step_i8` for int8,
`mega_decode_step` for bf16, `mega_decode_step_i4` for the int4 cache,
generate.py:99-178); an MoE tree (`"moe"`, Qwen3-Omni's thinker) runs the
MoE step of `ops/moe.py` (`moe_runner`: one CUDA graph replay a token) in
the greedy loop alone, its prefill's device counts fetched with the tokens
(the sampled, speculative, streaming and batched paths raise for it); any
other tree (dense bf16 or Q8_0 weights) runs the
per-layer decode step, `decoder_forward` at T = 1, over a bf16 or int8
cache. The int4 cache exists only as the decode pack's stream: the prefill
writes the int8 layout, which is packed once before the first step, and
without a decode pack an int4 cache runs as int8 (generate.py:60-64,
:380-386). The reference's streamed-KV mode (`kv_stream`, past its VMEM
budget) needs no switch here: the kernels read any S.

The rules stay: the cache holds S = P + max_tokens rounded up to 128 rows;
the token consumed by step i sits at position pos = n_prompt + i - 1; the
loop stops at EOS or max_tokens; n_kept counts the tokens before the first
EOS. `generate_greedy` never needs the host for a token (each step reads the
previous token from the device buffer); the host reads the buffer back
every EOS_CHECK_EVERY steps to test for EOS, so up to EOS_CHECK_EVERY - 1
steps may run past an EOS. Their tokens are filler, as in the JAX package,
and n_kept ignores them. The streaming path decodes `chunk` tokens per host
read and calls its callbacks per token; its chunks also run to their end
and keep the tokens up to the first EOS. `generate_sample` keeps the same
loop and host reads with a drawn token in place of the argmax;
`generate_greedy_spec` reads the host once per round.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.models.decoder import (
    _moe,
    _prefill_layers,
    _quantize_kv_rows,
    decode_step_batch,
    decoder_forward,
    decoder_prefill_batch,
    embed_with_audio,
    init_kv_cache,
    lm_logits,
    lm_logits_block,
)
from qwen3_asr_tpu_torch.ops.megakernel import (
    DecodeStep,
    GraphStep,
    mega_decode_step_ref,
    pack_kv_int4,
)
from qwen3_asr_tpu_torch.ops.megakernel_batch import (
    BatchDecodeStep,
    mega_decode_step_batch_ref,
)
from qwen3_asr_tpu_torch.ops.moe import MoeDecodeStep, moe_decode_step_ref
from qwen3_asr_tpu_torch.runtime.profiler import span

EOS_CHECK_EVERY = 16   # decode steps between the host's reads of the tokens
STREAM_CHUNK = 8       # decode steps per host read on the streaming path
# The cache_dtype that asks for the int4 cache: its stored type, nibble
# pairs in bytes (torch has no int4 dtype; the reference uses jnp.int4 as
# the same kind of marker).
INT4_KV = torch.uint8


def decode_hidden(dec_params: dict, cfg: DecoderConfig, cache: dict,
                  token: torch.Tensor, pos: int) -> torch.Tensor:
    """One step of the per-layer decode loop without its head: embed token
    (int32 [1] on the device), run decoder_forward at T = 1 at position pos
    over the cache rows < pos (writing row pos). -> the hidden state
    [hidden], before the final norm."""
    x = dec_params["token_embd"][token.long()]
    return decoder_forward(dec_params, cfg, x, cache, pos + 1, prefill=False,
                           cache_offset=pos)[0]


def decode_token(dec_params: dict, cfg: DecoderConfig, cache: dict,
                 out: torch.Tensor, i: int, pos: int) -> torch.Tensor:
    """One greedy step of the per-layer decode loop: decode_hidden on
    out[i - 1], and the argmax of the logits into out[i] on the device. ->
    the logits [vocab_size] f32."""
    logits = lm_logits(dec_params, cfg,
                       decode_hidden(dec_params, cfg, cache, out[i - 1:i], pos))
    out[i:i + 1] = torch.argmax(logits)
    return logits


def cache_rows(P: int, max_tokens: int) -> int:
    """Cache rows for a prompt bucket P and a token budget: P + max_tokens
    rounded up to 128."""
    return -(-(P + max_tokens) // 128) * 128


def kv_dtype(dec_params: dict, cache_dtype: torch.dtype) -> torch.dtype:
    """The cache a request decodes over: the int4 cache only with a decode
    pack (without one it runs as int8, as the reference's does)."""
    if cache_dtype == INT4_KV and "mega" not in dec_params:
        return torch.int8
    return cache_dtype


def prefill_hidden(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                   n_prompt: int, audio: torch.Tensor | None, n_audio: int,
                   audio_offset: int, S: int, cache_dtype: torch.dtype):
    """The prompt block (tokens [P] int32 on the device, rows >= n_prompt
    padding) into a fresh cache of S rows. -> (the last prompt row's hidden
    state [hidden], the cache), an int8 cache for the int4 one."""
    cache = init_kv_cache(cfg, S, tokens.device,
                          torch.int8 if cache_dtype == INT4_KV else cache_dtype)
    h0 = embed_with_audio(dec_params, tokens, audio, n_audio, audio_offset)
    h = decoder_forward(dec_params, cfg, h0, cache, n_prompt)
    return h[n_prompt - 1], cache


def prefill(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
            n_prompt: int, audio: torch.Tensor | None, n_audio: int,
            audio_offset: int, S: int, cache_dtype: torch.dtype):
    """Port of `prefill_only`: prefill_hidden, then the first greedy token.
    -> (that token int32 [1] on the device, the cache)."""
    with span("qwen3.prefill"):
        h_last, cache = prefill_hidden(dec_params, cfg, tokens, n_prompt, audio,
                                       n_audio, audio_offset, S, cache_dtype)
        first = torch.argmax(lm_logits(dec_params, cfg, h_last))
        return first.to(torch.int32).reshape(1), cache


def mega_caches(cfg: DecoderConfig, cache: dict, cache_dtype: torch.dtype):
    """The decode pack's flat caches (k, v [L, S, DKV], k_s, v_s) over the
    prefill's cache: views of it, or for the int4 cache its rows packed
    once (k, v uint8 [L, S/2, DKV], scales * 127/7)."""
    L, S = cache["k"].shape[:2]
    DKV = cfg.n_kv_heads * cfg.head_dim
    k, v = cache["k"].view(L, S, DKV), cache["v"].view(L, S, DKV)
    if cache_dtype == INT4_KV:
        (k, ks), (v, vs) = pack_kv_int4(k, cache["k_s"]), pack_kv_int4(v, cache["v_s"])
        return k, v, ks, vs
    return k, v, cache.get("k_s"), cache.get("v_s")


def mega_runner(pack: dict, cfg: DecoderConfig, kvs):
    """run(out, i, pos): one decode-pack step consuming out[i - 1] at
    position pos over the flat caches kvs, writing out[i] on the device: for
    CUDA tensors the kernels' step, captured once in a CUDA graph at the
    first call and replayed for every later token (GraphStep), for CPU ones
    the twin."""
    if kvs[0].device.type == "cuda":
        return GraphStep(DecodeStep(pack, cfg, *kvs))

    def run(out, i, pos):
        out[i:i + 1] = mega_decode_step_ref(pack, cfg, out[i - 1:i], pos, *kvs)[0]
    return run


def mega_sample_runner(pack: dict, cfg: DecoderConfig, kvs):
    """run(out, i, pos) -> h: one decode-pack step consuming out[i - 1] at
    position pos over the flat caches kvs, returning its hidden state before
    the final norm (f32 [1, H], the kernels' h_out, the reference's h_dbg).
    out[i] is left to the caller (the kernels' own argmax is unused). On
    CUDA tensors a GraphStep that copies out[i - 1] in before every replay,
    for CPU ones the twin."""
    if kvs[0].device.type == "cuda":
        graph = GraphStep(DecodeStep(pack, cfg, *kvs), own_tokens=False)

        def run(out, i, pos):
            graph(out, i, pos)
            return graph.h
        return run

    def run(out, i, pos):
        return mega_decode_step_ref(pack, cfg, out[i - 1:i], pos, *kvs)[1]
    return run


def moe_runner(pack: dict, cfg: DecoderConfig, kvs):
    """run(out, i, pos): one MoE decode step (`ops/moe.py`) consuming out[i -
    1] at position pos over the flat caches kvs, writing out[i] on the
    device: on CUDA tensors captured once in a CUDA graph and replayed for
    every later token (GraphStep), on CPU ones the twin. Counts
    `_moe.decode_steps`."""
    if kvs[0].device.type == "cuda":
        graph = GraphStep(MoeDecodeStep(pack, cfg, *kvs))

        def run(out, i, pos):
            graph(out, i, pos)
            _moe.decode_steps += 1
        return run

    def run(out, i, pos):
        out[i:i + 1] = moe_decode_step_ref(pack, cfg, out[i - 1:i], pos, *kvs)[0]
        _moe.decode_steps += 1
    return run


def _step_runner(dec_params: dict, cfg: DecoderConfig, cache: dict,
                 cache_dtype: torch.dtype):
    """run(out, i, pos) over the prefill's cache: the MoE step, the decode
    pack's step, or the per-layer step without one."""
    if "moe" in dec_params:
        return moe_runner(dec_params["moe"], cfg, mega_caches(cfg, cache, cache_dtype))
    if "mega" not in dec_params:
        def run(out, i, pos):
            decode_token(dec_params, cfg, cache, out, i, pos)
        return run
    return mega_runner(dec_params["mega"], cfg, mega_caches(cfg, cache, cache_dtype))


def _hidden_runner(dec_params: dict, cfg: DecoderConfig, cache: dict,
                   cache_dtype: torch.dtype):
    """run(out, i, pos) -> h over the prefill's cache: the step on out[i -
    1] without its head, through the decode pack's kernels or the per-layer
    step."""
    if "mega" not in dec_params:
        def run(out, i, pos):
            return decode_hidden(dec_params, cfg, cache, out[i - 1:i], pos)
        return run
    return mega_sample_runner(dec_params["mega"], cfg,
                              mega_caches(cfg, cache, cache_dtype))


def _decode_loop(step, out: torch.Tensor, n_prompt: int, eos: int,
                 n_tokens: int | None = None) -> tuple[np.ndarray, int]:
    """step(i, pos) writes out[i] on the device for i = 1, 2, ... n_tokens -
    1 (n_tokens: all of out, or its first n_tokens, the rest riding the
    final fetch); the token of step i sits at position n_prompt + i - 1.
    The host reads out for EOS every EOS_CHECK_EVERY steps. -> (out on the
    host, n_kept)."""
    n_tokens = out.shape[0] if n_tokens is None else n_tokens
    with span("qwen3.decode"):
        i = 1
        while i < n_tokens:
            if (i - 1) % EOS_CHECK_EVERY == 0 and bool((out[:i] == eos).any()):
                break
            step(i, n_prompt + i - 1)
            i += 1
        host = out.cpu().numpy()
    hits = np.flatnonzero(host[:i] == eos)
    return host, int(hits[0]) if hits.size else i


def generate_greedy(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                    n_prompt: int, audio: torch.Tensor | None, n_audio: int,
                    audio_offset: int, max_tokens: int,
                    cache_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[np.ndarray, int]:
    """tokens [P] int32 on the model's device (rows >= n_prompt are padding)
    -> (out_tokens [max_tokens] int32 on the host, n_kept). Tokens at index
    >= n_kept are filler; EOS is not counted. cache_dtype: torch.bfloat16
    (the reference's default), torch.int8 or INT4_KV."""
    cache_dtype = kv_dtype(dec_params, cache_dtype)
    S = cache_rows(tokens.shape[0], max_tokens)
    first, cache = prefill(dec_params, cfg, tokens, n_prompt, audio, n_audio,
                           audio_offset, S, cache_dtype)
    # an MoE prefill's device counts (_moe.stats) ride the tokens' fetch
    moe = "moe" in dec_params
    out = torch.zeros(max_tokens + (2 if moe else 0), dtype=torch.int32,
                      device=tokens.device)
    out[:1] = first
    if moe:
        out[max_tokens:] = _moe.stats
    run = _step_runner(dec_params, cfg, cache, cache_dtype)
    host, n_kept = _decode_loop(lambda i, pos: run(out, i, pos), out, n_prompt,
                                cfg.eos_token_id, max_tokens)
    if moe:
        _moe.experts_touched += int(host[max_tokens])
        _moe.rows_max = max(_moe.rows_max, int(host[max_tokens + 1]))
    return host[:max_tokens], n_kept


# ---------------------------------------------------------------------------
# sampled decoding (temperature / top-k / top-p)
# ---------------------------------------------------------------------------

NEG = float(np.finfo(np.float32).min)   # a dropped logit, as the reference sets it
TINY = float(np.finfo(np.float32).tiny)  # the uniforms' floor, as jax.random.gumbel's


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """The filters of the reference's `sample_from_logits`, in its order, on
    [V] logits -> f32 [V] with every dropped logit set to finfo(f32).min:
    the temperature (clamped at 1e-4) divides; top-k drops the logits below
    the k-th largest (ties with it are kept; 0 or >= V disables it); top-p
    keeps the smallest descending prefix whose probability reaches top_p,
    the cutoff element with it ("exclusive cumsum < top_p", so top_p >= 1.0
    keeps everything), and every logit tied with the cutoff. The cumsum runs
    in float64: on the card a float scan may add in another order from run
    to run, and at f64 that moves no f32 boundary."""
    logits = logits.float()
    t = max(np.float32(temperature), np.float32(1e-4))
    logits = logits / torch.tensor(t, dtype=torch.float32, device=logits.device)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k).values[-1]
        logits = torch.where(logits < kth, NEG, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, descending=True).values
        probs = torch.softmax(srt, dim=-1).double()
        keep = (torch.cumsum(probs, dim=-1) - probs) < float(np.float32(top_p))
        cut = torch.where(keep, srt, float("inf")).min()
        logits = torch.where(logits < cut, NEG, logits)
    return logits


def sample_from_logits(logits: torch.Tensor, u: torch.Tensor, temperature: float,
                       top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """One token id (int32 [1] on the logits' device) from [V] logits: the
    argmax at temperature <= 0; else the argmax of filter_logits plus the
    Gumbel noise -log(-log(u)) of u, f32 [V] uniforms in [0, 1) (floored
    at TINY): a draw from the kept softmax, the Gumbel-max draw of
    jax.random.categorical. A dropped logit never wins; for given u the
    draw has no scan in it and repeats bit for bit. No host read."""
    if temperature <= 0:
        return torch.argmax(logits).to(torch.int32).reshape(1)
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=TINY)))
    x = filter_logits(logits, temperature, top_k, top_p) + gumbel
    return torch.argmax(x).to(torch.int32).reshape(1)


def generate_sample(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                    n_prompt: int, audio: torch.Tensor | None, n_audio: int,
                    audio_offset: int, max_tokens: int, seed: int = 0,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                    cache_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[np.ndarray, int]:
    """Sampled generation, generate_greedy's contract: (out_tokens
    [max_tokens] int32 on the host, n_kept). Token i (the first too) is
    sample_from_logits on the lm head of step i's hidden state: with a
    decode pack the kernels' h_out (their own head and argmax unused)
    through the tree's head `lm_logits` (the int8pc copy on the auto path),
    as the reference samples from its kernel's h_dbg; without one the
    per-layer step's (K4-K7).

    Each step draws its [V] uniforms, in step order, from one
    torch.Generator on the tokens' device seeded with `seed`: step i's draw
    depends on i alone, not on the loop's chunking or graphs. The same seed
    gives the same tokens on one device; the CPU's and the card's generators
    give different ones, and neither matches jax.random's stream."""
    cfg.require_dense("sampled decoding (temperature > 0)")
    cache_dtype = kv_dtype(dec_params, cache_dtype)
    dev = tokens.device
    S = cache_rows(tokens.shape[0], max_tokens)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def pick(h):
        logits = lm_logits(dec_params, cfg, h.reshape(-1))
        u = torch.rand(logits.shape, device=dev, generator=gen)
        return sample_from_logits(logits, u, temperature, top_k, top_p)

    out = torch.zeros(max_tokens, dtype=torch.int32, device=dev)
    with span("qwen3.prefill"):
        h_last, cache = prefill_hidden(dec_params, cfg, tokens, n_prompt, audio,
                                       n_audio, audio_offset, S, cache_dtype)
        out[:1] = pick(h_last)
    run = _hidden_runner(dec_params, cfg, cache, cache_dtype)

    def step(i, pos):
        out[i:i + 1] = pick(run(out, i, pos))
    return _decode_loop(step, out, n_prompt, cfg.eos_token_id)


# ---------------------------------------------------------------------------
# greedy self-speculation
# ---------------------------------------------------------------------------

def accept(drafts: np.ndarray, verified: np.ndarray, room: int, eos: int
           ) -> tuple[np.ndarray, int, int, bool]:
    """One speculative round's acceptance on the host. The verify's token i
    is right while the draft fed it the true sequence: up to and with the
    first draft that differs from the verify's token (all k when none
    does), clipped at `room` (max_tokens - n), kept up to the first EOS
    among them. -> (the round's tokens, always the verify's; n_acc, kept,
    whether an EOS ended the sequence)."""
    mism = np.flatnonzero(drafts != verified)
    n_acc = min(int(mism[0]) + 1 if mism.size else len(drafts), room)
    hits = np.flatnonzero(verified[:n_acc] == eos)
    return verified, n_acc, int(hits[0]) if hits.size else n_acc, bool(hits.size)


def generate_greedy_spec(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                         n_prompt: int, audio: torch.Tensor | None, n_audio: int,
                         audio_offset: int, max_tokens: int, k: int = 8
                         ) -> tuple[np.ndarray, int, dict]:
    """Greedy self-speculation over an int8 cache: each round drafts k
    tokens through the decode pack's int8-cache step (K1, either pack; a
    GraphStep on the card), then verifies them in one block pass of k rows,
    [cur, d0 .. d_{k-2}] at positions pos0 .. pos0 + k - 1, through
    decoder_forward over the tree without its pack (the int8pc leaves),
    which overwrites the drafts' cache rows. The emitted tokens are always
    the verify's argmaxes: the per-layer int8pc greedy sequence over an
    int8 cache, whatever the drafts, which only set how many verified tokens
    a round keeps (up to and with the first mismatch, clipped at
    max_tokens - n, stopped at EOS). One host read per round.

    Unlike the reference there is no guard on the megakernel's VMEM budget
    (long audio): the kernels read any S. -> (out [max_tokens] int32 on the
    host, n_kept, {"rounds", "drafted", "accepted"})."""
    cfg.require_dense("speculative decoding (spec_k)")
    if k < 1:
        raise ValueError(f"spec k must be >= 1, got {k}")
    if "mega" not in dec_params:
        raise ValueError("generate_greedy_spec drafts through the decode pack "
                         "(quantize int8pc / auto / int4)")
    dev = tokens.device
    # room for one draft block past the budget (the last round's verify may
    # write rows up to n_prompt + max_tokens + k - 2)
    S = cache_rows(tokens.shape[0], max_tokens + k)
    first, cache = prefill(dec_params, cfg, tokens, n_prompt, audio, n_audio,
                           audio_offset, S, torch.int8)
    vparams = {key: val for key, val in dec_params.items() if key != "mega"}
    draft = mega_runner(dec_params["mega"], cfg, mega_caches(cfg, cache, torch.int8))
    eos = cfg.eos_token_id
    d = torch.zeros(k + 1, dtype=torch.int32, device=dev)   # [cur, d0 .. d_{k-1}]
    d[:1] = first
    out = np.zeros(max_tokens + k, np.int32)
    out[0] = int(first[0])
    done = bool(out[0] == eos)
    n = 0 if done else 1
    stats = {"rounds": 0, "drafted": 0, "accepted": 0}
    with span("qwen3.decode"):
        while not done and n < max_tokens:
            pos0 = n_prompt + n - 1
            for j in range(1, k + 1):
                draft(d, j, pos0 + j - 1)
            hb = vparams["token_embd"][d[:k].long()]
            hv = decoder_forward(vparams, cfg, hb, cache, pos0 + k, prefill=False,
                                 cache_offset=pos0)
            v = torch.argmax(lm_logits_block(vparams, cfg, hv), dim=-1).to(torch.int32)
            host = torch.cat([d[1:], v]).cpu().numpy()
            emitted, n_acc, kept, done = accept(host[:k], host[k:], max_tokens - n, eos)
            out[n:n + k] = emitted
            if kept:
                d[:1] = int(emitted[kept - 1])
            stats["rounds"] += 1
            stats["drafted"] += k
            stats["accepted"] += n_acc
            n += kept
    return out[:max_tokens], n, stats


# ---------------------------------------------------------------------------
# the streaming path
# ---------------------------------------------------------------------------

def _chunk(run, token: torch.Tensor, pos0: int, n_steps: int, limit: int,
           eos: int) -> tuple[np.ndarray, int]:
    """Up to `limit` (<= n_steps) greedy successors of `token` (int32 [1] on
    the device) at positions pos0, pos0 + 1, ..., with one host read. The
    device runs all `limit` steps; the successors after the first EOS are
    dropped (zeros). -> (successors int32 [n_steps] on the host,
    n_generated: up to and with the first EOS)."""
    buf = torch.zeros(n_steps + 1, dtype=torch.int32, device=token.device)
    buf[:1] = token
    for i in range(1, limit + 1):
        run(buf, i, pos0 + i - 1)
    succ = buf[1:].cpu().numpy()
    hits = np.flatnonzero(succ[:limit] == eos)
    n = int(hits[0]) + 1 if hits.size else limit
    succ[n:] = 0
    return succ, n


def decode_chunk(dec_params: dict, cfg: DecoderConfig, token: torch.Tensor,
                 pos0: int, cache: dict, n_steps: int, limit: int
                 ) -> tuple[np.ndarray, int]:
    """Up to `limit` greedy successors of `token` through the per-layer
    step over `cache` (written in place). -> (successors [n_steps],
    n_generated), n_generated counting up to and with the first EOS."""
    def run(out, i, pos):
        decode_token(dec_params, cfg, cache, out, i, pos)
    return _chunk(run, token, pos0, n_steps, limit, cfg.eos_token_id)


def _decode_chunk_mega_any(dec_params: dict, cfg: DecoderConfig, token: torch.Tensor,
                           pos0: int, kvs, n_steps: int, limit: int, run=None
                           ) -> tuple[np.ndarray, int]:
    """decode_chunk through the decode pack's step over the flat caches
    kvs = (k, v, k_s, v_s) (scales None for bf16), written in place; `run`
    is a mega_runner bound to them (made here when None). Same
    (successors, n_generated) contract as decode_chunk."""
    run = run or mega_runner(dec_params["mega"], cfg, kvs)
    return _chunk(run, token, pos0, n_steps, limit, cfg.eos_token_id)


def decode_chunk_mega(dec_params, cfg, token, pos0, k3, v3, n_steps, limit):
    """decode_chunk through the bf16-KV step (flat caches [L, S, DKV])."""
    return _decode_chunk_mega_any(dec_params, cfg, token, pos0, (k3, v3, None, None),
                                  n_steps, limit)


def decode_chunk_mega_i8(dec_params, cfg, token, pos0, k3, v3, ks, vs, n_steps, limit):
    """decode_chunk through the int8-KV step (scales [L, S, n_kv])."""
    return _decode_chunk_mega_any(dec_params, cfg, token, pos0, (k3, v3, ks, vs),
                                  n_steps, limit)


def decode_chunk_mega_i4(dec_params, cfg, token, pos0, k3, v3, ks, vs, n_steps, limit):
    """decode_chunk through the int4-KV step (nibble pairs [L, S/2, DKV],
    scales [L, S, n_kv])."""
    return _decode_chunk_mega_any(dec_params, cfg, token, pos0, (k3, v3, ks, vs),
                                  n_steps, limit)


def generate_greedy_streaming(dec_params: dict, cfg: DecoderConfig,
                              tokens: torch.Tensor, n_prompt: int,
                              audio: torch.Tensor | None, n_audio: int,
                              audio_offset: int, max_tokens: int, on_token=None,
                              cache_dtype: torch.dtype = torch.bfloat16,
                              chunk: int = STREAM_CHUNK, on_token_id=None) -> list[int]:
    """Greedy decode with a host loop, calling `on_token(i, max_tokens)` per
    token (the reference's progress contract) and, when given,
    `on_token_id(token)` with each token id (the server's SSE streams ride
    it). Decodes `chunk` tokens per host read; the callbacks stay per token.
    Same tokens as generate_greedy. -> the tokens, EOS not included."""
    cfg.require_dense("the streaming decode (a progress or token callback)")
    cache_dtype = kv_dtype(dec_params, cache_dtype)
    S = cache_rows(tokens.shape[0], max_tokens)
    token, cache = prefill(dec_params, cfg, tokens, n_prompt, audio, n_audio,
                           audio_offset, S, cache_dtype)
    if "mega" in dec_params:
        kvs = mega_caches(cfg, cache, cache_dtype)
        run = mega_runner(dec_params["mega"], cfg, kvs)

        def decode(token, pos0, limit):
            return _decode_chunk_mega_any(dec_params, cfg, token, pos0, kvs, chunk,
                                          limit, run)
    else:
        def decode(token, pos0, limit):
            return decode_chunk(dec_params, cfg, token, pos0, cache, chunk, limit)
    out: list[int] = []

    def emit(t: int) -> bool:
        if t == cfg.eos_token_id or len(out) >= max_tokens:
            return False
        out.append(t)
        if on_token:
            on_token(len(out), max_tokens)
        if on_token_id:
            on_token_id(t)
        return len(out) < max_tokens

    with span("qwen3.decode"):
        if not emit(int(token[0])):
            return out
        while True:
            limit = min(chunk, max_tokens - len(out))
            succ, n = decode(token, n_prompt + len(out) - 1, limit)
            arr = succ[:n]
            if len(arr) == 0:
                break
            token = torch.tensor(arr[-1:], dtype=torch.int32, device=tokens.device)
            if not all(emit(int(t)) for t in arr) or n < limit:
                break
    return out


def prefill_batch_mega_cache(dec_params: dict, cfg: DecoderConfig,
                             tokens: torch.Tensor, n_prompt, audio: torch.Tensor,
                             n_audio, audio_offset: int, S: int,
                             cache_dtype: torch.dtype = torch.int8):
    """Batched prefill into the batched decode step's cache layout.
    tokens [B, P] int32 on the device (prompts left-aligned and padded to
    P), n_prompt / n_audio host sequences of B ints, audio [B, N, hidden]
    (the first n_audio[b] rows of item b are spliced over its audio_pad
    rows). -> (first tokens int32 [B] on the device, k, v [B, L, S, n_kv *
    head_dim] int8 with k_s, v_s [B, L, S, n_kv] f32, or, for a bf16
    cache_dtype, bf16 with k_s = v_s = None), rows >= P zero."""
    cfg.require_dense("batched decoding (transcribe_batch, the server's closed batches)")
    with span("qwen3.prefill"):
        B, P = tokens.shape
        L, NKV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        n_prompt = np.asarray(n_prompt, np.int64).reshape(-1)
        h0 = torch.stack([
            embed_with_audio(dec_params, tokens[b], audio[b], int(n_audio[b]),
                             audio_offset) for b in range(B)])
        valid = torch.from_numpy(n_prompt.astype(np.int32)).to(tokens.device)
        h, rows = decoder_prefill_batch(dec_params, cfg, h0, valid)
        h_last = h[torch.arange(B, device=h.device), valid.long() - 1]
        first = torch.argmax(lm_logits_block(dec_params, cfg, h_last),
                             dim=-1).to(torch.int32)
        out = []
        for name in ("k", "v"):
            c = torch.zeros(B, L, S, NKV * D, dtype=cache_dtype, device=tokens.device)
            if cache_dtype == torch.bfloat16:
                c[:, :, :P] = rows[name].transpose(0, 1).reshape(B, L, P, NKV * D)
                out += [c, None]
                continue
            q8, sc = _quantize_kv_rows(rows[name])          # [L, B, P, NKV(, D)]
            cs = torch.zeros(B, L, S, NKV, dtype=torch.float32, device=tokens.device)
            c[:, :, :P] = q8.transpose(0, 1).reshape(B, L, P, NKV * D)
            cs[:, :, :P] = sc.transpose(0, 1)
            out += [c, cs]
        return first, out[0], out[2], out[1], out[3]


def _batch_loop(step, first: torch.Tensor, max_tokens: int, eos: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """The lockstep loop of B sequences: new = step(cur, i) gives step i's
    tokens int32 [B] on the device (their inputs cur). A finished row keeps
    stepping with its outputs frozen (zeros after its EOS) until every row
    is done or the budget runs out; the host reads the done flags every
    EOS_CHECK_EVERY steps. -> (out [B, max_tokens] int32, n_kept [B]) on the
    host."""
    with span("qwen3.decode"):
        B = first.shape[0]
        out = torch.zeros(B, max_tokens, dtype=torch.int32, device=first.device)
        out[:, 0] = first
        done = first == eos
        nk = (~done).to(torch.int32)
        cur = first
        for i in range(1, max_tokens):
            if (i - 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
                break
            new = torch.where(done, cur, step(cur, i))
            out[:, i] = torch.where(done, out[:, i], new)
            hit = new == eos
            nk = torch.where(done, nk, torch.where(hit, i, i + 1).to(torch.int32))
            done = done | hit
            cur = new
        return out.cpu().numpy(), nk.cpu().numpy()


def generate_greedy_batch_mega(dec_params: dict, cfg: DecoderConfig,
                               tokens: torch.Tensor, n_prompt, audio: torch.Tensor,
                               n_audio, audio_offset: int, max_tokens: int,
                               cache_dtype: torch.dtype = torch.int8
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Batched greedy generation, B <= 16 sequences in lockstep through the
    batched decode step (the pack's weights are read once per step for the
    batch), over an int8 or (cache_dtype torch.bfloat16) a bf16 cache.
    Arguments as in prefill_batch_mega_cache, the loop _batch_loop's. ->
    (out [B, max_tokens] int32, n_kept [B]) on the host."""
    B, P = tokens.shape
    dev = tokens.device
    S = cache_rows(P, max_tokens)
    n_prompt = np.asarray(n_prompt, np.int64).reshape(-1)
    first, k, v, ks, vs = prefill_batch_mega_cache(
        dec_params, cfg, tokens, n_prompt, audio, n_audio, audio_offset, S, cache_dtype)
    pack = dec_params["mega"]
    n_prompt_d = torch.from_numpy(n_prompt.astype(np.int32)).to(dev)
    if dev.type == "cuda":
        kernels = BatchDecodeStep(pack, cfg, k, v, ks, vs)
        nxt = torch.empty(B, dtype=torch.int32, device=dev)

    def step(cur, i):
        pos = n_prompt + i - 1
        if dev.type != "cuda":
            return mega_decode_step_batch_ref(pack, cfg, cur, pos, k, v, ks, vs)[0]
        kernels(cur, n_prompt_d + (i - 1), nxt, (int(pos.min()), int(pos.max())))
        return nxt
    return _batch_loop(step, first, max_tokens, cfg.eos_token_id)


def generate_greedy_batch(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                          n_prompt, audio: torch.Tensor, n_audio, audio_offset: int,
                          max_tokens: int, cache_dtype: torch.dtype = torch.bfloat16
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Batched greedy generation on the per-layer decode step (a tree
    without a decode pack: Q8_0 or dense leaves), the reference's vmapped
    `generate_greedy`: the batched prefill into a cache of B slabs
    (prefill_batch_mega_cache's pool, bf16 or int8; the int4 cache runs as
    int8), then _batch_loop over decode_step_batch (K4 batched, K5-K7 at T = B) and the
    lm head over the B rows (K6 on the Q8_0 copy). Arguments as in
    prefill_batch_mega_cache. -> (out [B, max_tokens] int32, n_kept [B]) on
    the host."""
    P = tokens.shape[1]
    dev = tokens.device
    cache_dtype = torch.int8 if cache_dtype == INT4_KV else cache_dtype
    n_prompt = np.asarray(n_prompt, np.int64).reshape(-1)
    first, k, v, ks, vs = prefill_batch_mega_cache(
        dec_params, cfg, tokens, n_prompt, audio, n_audio, audio_offset,
        cache_rows(P, max_tokens), cache_dtype)
    cache = {"k": k, "v": v} if ks is None else {"k": k, "v": v, "k_s": ks, "v_s": vs}
    n_prompt_d = torch.from_numpy(n_prompt.astype(np.int32)).to(dev)

    def step(cur, i):
        x = dec_params["token_embd"][cur.long()]
        h = decode_step_batch(dec_params, cfg, x, cache, n_prompt_d + (i - 1),
                              n_prompt + i - 1)
        return torch.argmax(lm_logits_block(dec_params, cfg, h), dim=-1).to(torch.int32)
    return _batch_loop(step, first, max_tokens, cfg.eos_token_id)


def nar_forward_batch(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                      audio: torch.Tensor, n_audio, audio_offset: int,
                      n_valid) -> torch.Tensor:
    """The aligner's non-autoregressive pass on a batch: tokens [B, P]
    (prompts left-aligned, right-padded), audio [B, N, hidden] spliced over
    rows [audio_offset, audio_offset + n_audio[b]), n_valid [B] the real
    prompt lengths -> hidden states [B, P, hidden]. One causal prefill
    through the decoder's layer stack (K2 causal, batched, keys at index >=
    n_valid[b] masked); rows past n_valid[b] are padding the caller
    ignores. Unlike the JAX package, which allocates a KV cache and drops
    it, no cache is kept: the layer stack's on_rows stores nothing."""
    B = tokens.shape[0]
    h = torch.stack([embed_with_audio(dec_params, tokens[b], audio[b], int(n_audio[b]),
                                      audio_offset) for b in range(B)])
    valid = torch.as_tensor(np.asarray(n_valid, np.int32), device=h.device)
    return _prefill_layers(dec_params, cfg, h, valid, lambda l, k, v: None)


def nar_forward(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                audio: torch.Tensor, n_audio: int, audio_offset: int,
                n_valid: int | None = None) -> torch.Tensor:
    """Port of qwen3_asr_tpu/models/generate.py::nar_forward: one sequence,
    tokens [P], audio [N, hidden], n_valid the real prompt length (P when
    None) -> hidden states [P, hidden] (nar_forward_batch at B = 1)."""
    P = tokens.shape[0]
    return nar_forward_batch(dec_params, cfg, tokens[None], audio[None], [n_audio],
                             audio_offset, [P if n_valid is None else n_valid])[0]
