"""Greedy generation: the prefill, then the decode loop, for one sequence
or (decode pack, int8 cache) a batch in lockstep.

Port of qwen3_asr_tpu/models/generate.py:36-207 and of
`prefill_batch_mega_cache` / `generate_greedy_batch_mega` (:465-578), the
batched path. The branch follows what the tree holds, as in the reference:
a decode pack (`"mega"`, int4 or int8 weights) runs each step through the
decode megakernel, its entry picked by the cache dtype (`mega_decode_step_i8`
for int8, `mega_decode_step` for bf16, generate.py:143-173); any other tree
(dense bf16 or Q8_0 weights) runs the per-layer decode step,
`decoder_forward` at T = 1, over a bf16 or int8 cache. The rules stay: the
cache holds S = P + max_tokens rounded up to 128 rows; the token consumed by
step i sits at position
pos = n_prompt + i - 1; the loop stops at EOS or max_tokens; n_kept counts
the tokens before the first EOS. The loop never needs the host for a token
(each step reads the previous token from the device buffer); the host reads
the buffer back every EOS_CHECK_EVERY steps to test for EOS, so up to
EOS_CHECK_EVERY - 1 steps may run past an EOS. Their tokens are filler, as in
the JAX package, and n_kept ignores them.
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.models.decoder import (
    _quantize_kv_rows,
    decoder_forward,
    decoder_prefill_batch,
    embed_with_audio,
    init_kv_cache,
    lm_logits,
    lm_logits_block,
)
from qwen3_asr_tpu_torch.ops.megakernel import DecodeStep, mega_decode_step_ref
from qwen3_asr_tpu_torch.ops.megakernel_batch import (
    BatchDecodeStep,
    mega_decode_step_batch_ref,
)

EOS_CHECK_EVERY = 16   # decode steps between the host's reads of the tokens


def decode_token(dec_params: dict, cfg: DecoderConfig, cache: dict,
                 out: torch.Tensor, i: int, pos: int) -> torch.Tensor:
    """One step of the per-layer decode loop: embed out[i - 1], run
    decoder_forward at T = 1 at position pos over the cache rows < pos
    (writing row pos), and write the argmax of the logits into out[i] on the
    device. -> the logits [vocab_size] f32."""
    x = dec_params["token_embd"][out[i - 1:i].long()]
    h = decoder_forward(dec_params, cfg, x, cache, pos + 1, prefill=False,
                        cache_offset=pos)
    logits = lm_logits(dec_params, cfg, h[0])
    out[i:i + 1] = torch.argmax(logits)
    return logits


def generate_greedy(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                    n_prompt: int, audio: torch.Tensor | None, n_audio: int,
                    audio_offset: int, max_tokens: int,
                    cache_dtype: torch.dtype = torch.bfloat16
                    ) -> tuple[np.ndarray, int]:
    """tokens [P] int32 on the model's device (rows >= n_prompt are padding)
    -> (out_tokens [max_tokens] int32 on the host, n_kept). Tokens at index
    >= n_kept are filler; EOS is not counted. cache_dtype: torch.bfloat16
    (the reference's default) or torch.int8."""
    P = tokens.shape[0]
    S = cache_rows(P, max_tokens)
    dev = tokens.device
    L, NKV, D = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    mega = "mega" in dec_params
    cache = init_kv_cache(cfg, S, dev, cache_dtype)

    h0 = embed_with_audio(dec_params, tokens, audio, n_audio, audio_offset)
    h = decoder_forward(dec_params, cfg, h0, cache, n_prompt)
    first = torch.argmax(lm_logits(dec_params, cfg, h[n_prompt - 1]))

    out = torch.zeros(max_tokens, dtype=torch.int32, device=dev)
    out[0] = first.to(torch.int32)
    if not mega:
        def run(i, pos):
            # the token consumed by step i sits at position pos = n_prompt + i - 1
            decode_token(dec_params, cfg, cache, out, i, pos)
    else:
        pack = dec_params["mega"]
        kv = (cache["k"].view(L, S, NKV * D), cache["v"].view(L, S, NKV * D),
              cache.get("k_s"), cache.get("v_s"))
        if dev.type == "cuda":
            step = DecodeStep(pack, cfg, *kv)

            def run(i, pos):
                step(out[i - 1:i], pos, out[i:i + 1])
        else:
            def run(i, pos):
                out[i:i + 1] = mega_decode_step_ref(pack, cfg, out[i - 1:i], pos,
                                                    *kv)[0]

    eos = cfg.eos_token_id
    i = 1
    while i < max_tokens:
        if (i - 1) % EOS_CHECK_EVERY == 0 and bool((out[:i] == eos).any()):
            break
        run(i, n_prompt + i - 1)
        i += 1
    host = out.cpu().numpy()
    hits = np.flatnonzero(host[:i] == eos)
    return host, int(hits[0]) if hits.size else i


def cache_rows(P: int, max_tokens: int) -> int:
    """Cache rows for a prompt bucket P and a token budget: P + max_tokens
    rounded up to 128."""
    return -(-(P + max_tokens) // 128) * 128


def prefill_batch_mega_cache(dec_params: dict, cfg: DecoderConfig,
                             tokens: torch.Tensor, n_prompt, audio: torch.Tensor,
                             n_audio, audio_offset: int, S: int):
    """Batched prefill into the batched decode step's cache layout.
    tokens [B, P] int32 on the device (prompts left-aligned and padded to
    P), n_prompt / n_audio host sequences of B ints, audio [B, N, hidden]
    (the first n_audio[b] rows of item b are spliced over its audio_pad
    rows). -> (first tokens int32 [B] on the device, k, v [B, L, S, n_kv *
    head_dim] int8, k_s, v_s [B, L, S, n_kv] f32), rows >= P zero."""
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
        q8, sc = _quantize_kv_rows(rows[name])          # [L, B, P, NKV(, D)]
        c = torch.zeros(B, L, S, NKV * D, dtype=torch.int8, device=h.device)
        cs = torch.zeros(B, L, S, NKV, dtype=torch.float32, device=h.device)
        c[:, :, :P] = q8.transpose(0, 1).reshape(B, L, P, NKV * D)
        cs[:, :, :P] = sc.transpose(0, 1)
        out += [c, cs]
    return first, out[0], out[2], out[1], out[3]


def generate_greedy_batch_mega(dec_params: dict, cfg: DecoderConfig,
                               tokens: torch.Tensor, n_prompt, audio: torch.Tensor,
                               n_audio, audio_offset: int, max_tokens: int
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Batched greedy generation, B <= 16 sequences in lockstep through the
    batched decode step (the pack's weights are read once per step for the
    batch), over an int8 cache. Arguments as in prefill_batch_mega_cache. A finished row keeps
    stepping with its outputs frozen (zeros after its EOS) until every row
    is done or the budget runs out; the host reads the done flags every
    EOS_CHECK_EVERY steps. -> (out [B, max_tokens] int32, n_kept [B]) on
    the host."""
    B, P = tokens.shape
    dev = tokens.device
    S = cache_rows(P, max_tokens)
    n_prompt = np.asarray(n_prompt, np.int64).reshape(-1)
    first, k, v, ks, vs = prefill_batch_mega_cache(
        dec_params, cfg, tokens, n_prompt, audio, n_audio, audio_offset, S)
    eos = cfg.eos_token_id
    out = torch.zeros(B, max_tokens, dtype=torch.int32, device=dev)
    out[:, 0] = first
    done = first == eos
    nk = (~done).to(torch.int32)
    cur = first
    pack = dec_params["mega"]
    n_prompt_d = torch.from_numpy(n_prompt.astype(np.int32)).to(dev)
    if dev.type == "cuda":
        step = BatchDecodeStep(pack, cfg, k, v, ks, vs)
        nxt = torch.empty(B, dtype=torch.int32, device=dev)
    for i in range(1, max_tokens):
        if (i - 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
        pos = n_prompt + i - 1
        if dev.type == "cuda":
            step(cur, n_prompt_d + (i - 1), nxt, (int(pos.min()), int(pos.max())))
            new = nxt
        else:
            new = mega_decode_step_batch_ref(pack, cfg, cur, pos, k, v, ks, vs)[0]
        new = torch.where(done, cur, new)
        out[:, i] = torch.where(done, out[:, i], new)
        hit = new == eos
        nk = torch.where(done, nk, torch.where(hit, i, i + 1).to(torch.int32))
        done = done | hit
        cur = new
    return out.cpu().numpy(), nk.cpu().numpy()
