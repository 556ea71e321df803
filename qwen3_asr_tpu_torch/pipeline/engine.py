"""Continuous (in-flight) batching: a slot-pool decode engine.

Port of qwen3_asr_tpu/pipeline/engine.py:54-541 on one device. A closed
batch makes a request that arrives one step after launch wait for the whole
batch; the engine instead decodes in fixed-size rounds of `round_tokens`
batched decode steps, and between rounds the batch re-opens: finished slots
(EOS or token budget) retire and deliver, queued requests prefill into the
free slots, the next round launches.

State split, as in the JAX package: the KV cache pool (one slab per slot,
`[pool, L, S, ...]`) lives on the device and is updated in place; the
per-slot bookkeeping (current token, cache position, live flag) is host
numpy between rounds. During a round `cur`, `pos` and `live` stay on the
device (one upload at the start, one read at the end); the host knows an
upper bound of every row's position (its value at round start plus the
step index), and that bound sizes the batched step's attention grid. Slot
rules: dead lanes compute but their outputs are masked; a lane that emits
EOS freezes its position; a newcomer's prefilled slab replaces the whole
slab of its slot, so no row of an earlier occupant survives. The port also
stops a lane on the device once its token budget is met (the JAX engine
lets it run to the round's end and the host ignores those tokens): the
emitted tokens are the same, and every position stays inside the slab.

Not ported: the dp mesh, `kv_stream`, and the VMEM sizing of the pool
(`mega_batch_max_context`): the card's batched step takes any context.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.text.prompt import build_asr_prompt
from qwen3_asr_tpu_torch.text.timestamps import get_feat_extract_output_lengths
from qwen3_asr_tpu_torch.audio.mel import num_mel_frames
from qwen3_asr_tpu_torch.models.generate import cache_rows, prefill_batch_mega_cache
from qwen3_asr_tpu_torch.ops.megakernel_batch import (
    MAX_BATCH,
    BatchDecodeStep,
    mega_decode_step_batch_ref,
)
from qwen3_asr_tpu_torch.pipeline.asr import (
    TranscribeResult,
    batch_prompts,
    frontend_feats_batch,
)
from qwen3_asr_tpu_torch.runtime.profiler import span

DEFAULT_AUDIO_S = 92          # the longest utterance a default pool admits
POOL_MEMORY_SHARE = 0.25      # of the device's free memory, at most


def prompt_rows(dcfg: DecoderConfig, n_samples: int, prompt_bucket: int) -> int:
    """The bucketed prompt length of an utterance of n_samples 16 kHz
    samples."""
    n_audio = get_feat_extract_output_lengths(num_mel_frames(int(n_samples)))
    return -(-len(build_asr_prompt(n_audio, dcfg)) // prompt_bucket) * prompt_bucket


def default_context(asr, pool: int, max_tokens: int, prompt_bucket: int) -> int:
    """The pool context S when none is given: the bucketed prompt of a
    DEFAULT_AUDIO_S utterance plus max_tokens, rounded up to 128 (2,304 rows
    for the 0.6B model at 1,024 tokens: a 1,280-row prompt bucket plus
    1,024), lowered to fit the pool's int8 K/V slabs and f32 scales in
    POOL_MEMORY_SHARE of the free device memory."""
    dcfg = asr.cfg.decoder
    S = cache_rows(prompt_rows(dcfg, DEFAULT_AUDIO_S * 16000, prompt_bucket),
                   max_tokens)
    if asr.device.type == "cuda":
        row = pool * dcfg.n_layers * 2 * (dcfg.n_kv_heads * dcfg.head_dim
                                          + 4 * dcfg.n_kv_heads)
        free = torch.cuda.mem_get_info(asr.device)[0]
        S = min(S, int(free * POOL_MEMORY_SHARE) // row // 128 * 128)
    return S


@dataclasses.dataclass
class _Slot:
    """One occupied pool lane."""
    ticket: object               # caller's handle (request/future/...)
    tokens: list                 # emitted token ids (EOS excluded)
    max_tokens: int
    t_start: float
    finished: bool = False       # EOS seen or budget hit
    notified: int = 0            # tokens already reported via on_progress


class ContinuousEngine:
    """Slot-pool continuous batching over the batched decode step.

    Drive it from ONE thread (the server worker): `admit()` newcomers into
    free slots, `run_round()` to decode; completed requests come back from
    run_round as (ticket, TranscribeResult). The engine owns no threads and
    no queues. Requests whose bucketed prompt + max_tokens exceed the pool
    context (see `eligible`) must go down the caller's closed-batch path.
    """

    def __init__(self, asr, pool: int = 8, round_tokens: int = 64,
                 max_tokens: int = 1024, prompt_bucket: int = 128,
                 mel_bucket: int = 800, s_pool: int | None = None):
        asr.cfg.decoder.require_dense("the continuous engine (ContinuousEngine)")
        if "mega" not in asr.params["decoder"]:
            raise NotImplementedError(
                f"the continuous engine runs the batched decode step on the decode "
                f"pack; quantize={asr.quantize or False!r} has none")
        if asr.kv_cache != "int8":   # the reference's engine takes int8 only
            raise NotImplementedError(
                f"the continuous engine runs the batched decode step over the int8 "
                f"KV cache only; kv_cache={asr.kv_cache!r}")
        self.asr = asr
        self.dcfg: DecoderConfig = asr.cfg.decoder
        self.pool = int(pool)
        if not 1 <= self.pool <= MAX_BATCH:
            raise ValueError(f"pool must be 1..{MAX_BATCH} (one batched step)")
        self.round_tokens = int(round_tokens)
        self.max_tokens = int(max_tokens)
        self.prompt_bucket = int(prompt_bucket)
        self.mel_bucket = int(mel_bucket)
        self.S = int(s_pool) if s_pool else default_context(
            asr, self.pool, self.max_tokens, self.prompt_bucket)
        if self.S % 128 or self.S <= 0:
            raise ValueError(f"pool context must be a positive multiple of "
                             f"128, got {self.S}")
        self._alloc_pool()
        B = self.pool
        self._cur = np.zeros(B, np.int32)
        self._pos = np.ones(B, np.int32)  # dead lanes scribble row 1
        self._slots: list = [None] * B
        # optional per-round progress hook: called on the driving thread
        # as on_progress(ticket, new_token_ids) after every round for each
        # slot that gained tokens (streaming deltas ride this: serve.py)
        self.on_progress = None
        self.n_rounds = 0
        self.n_admitted = 0
        self.n_completed = 0
        self.busy_slot_steps = 0   # live-lane steps actually used
        self.total_slot_steps = 0  # pool lanes x steps run

    def _alloc_pool(self) -> None:
        """(Re)allocate the device's KV cache pool (zeros) and the batched
        step bound to it."""
        d = self.dcfg
        B, L, S = self.pool, d.n_layers, self.S
        dev = self.asr.device
        DKV, NKV = d.n_kv_heads * d.head_dim, d.n_kv_heads
        self._kv = [torch.zeros(B, L, S, DKV, dtype=torch.int8, device=dev),
                    torch.zeros(B, L, S, DKV, dtype=torch.int8, device=dev),
                    torch.zeros(B, L, S, NKV, dtype=torch.float32, device=dev),
                    torch.zeros(B, L, S, NKV, dtype=torch.float32, device=dev)]
        self._step = (BatchDecodeStep(self.asr.params["decoder"]["mega"], d,
                                      *self._kv) if dev.type == "cuda" else None)

    # -- capacity ---------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    def n_active(self) -> int:
        return sum(s is not None for s in self._slots)

    def eligible(self, n_samples: int, max_tokens: int | None = None) -> bool:
        """Whether an utterance of n_samples 16 kHz samples fits a pool
        slot: bucketed prompt + its token budget within the pool's S."""
        P = prompt_rows(self.dcfg, n_samples, self.prompt_bucket)
        return P + (max_tokens or self.max_tokens) <= self.S

    # -- admission --------------------------------------------------------

    def admit(self, tickets: list, samples: list) -> None:
        """Prefill `samples[i]` (int16/float32 16 kHz numpy) into free
        slots, one per ticket: one batched frontend pass per mel bucket and
        one batched prefill. Caller guarantees len(tickets) <=
        len(free_slots()) and eligibility."""
        if not tickets:
            return
        free = self.free_slots()
        if len(tickets) > len(free):
            raise ValueError(f"admit(): {len(tickets)} requests for "
                             f"{len(free)} free slots")
        dcfg, asr = self.dcfg, self.asr
        feats = frontend_feats_batch(asr, list(samples), self.mel_bucket)
        toks, n_prompt, n_audio, audio, offset = batch_prompts(
            asr, feats, self.prompt_bucket)
        if toks.shape[1] >= self.S:
            raise ValueError(
                f"admit(): bucketed prompt {toks.shape[1]} does not fit the "
                f"pool context {self.S}; the caller must gate on eligible()")
        b = len(tickets)
        first, *slabs = prefill_batch_mega_cache(
            asr.params["decoder"], dcfg, toks, n_prompt, audio, n_audio, offset,
            self.S)
        first = first.cpu().numpy()
        idx = free[:b]
        idx_d = torch.tensor(idx, device=asr.device)
        for pool_t, new in zip(self._kv, slabs):
            pool_t[idx_d] = new           # whole-slab replacement
        now = time.perf_counter()
        for j, ticket in enumerate(tickets):
            slot, tok0 = idx[j], int(first[j])
            s = _Slot(ticket=ticket, tokens=[], max_tokens=self.max_tokens,
                      t_start=now)
            if tok0 == dcfg.eos_token_id:
                s.finished = True     # degenerate: empty transcript
            else:
                s.tokens.append(tok0)
                s.finished = s.max_tokens <= 1
            self._slots[slot] = s
            self._cur[slot] = tok0
            self._pos[slot] = int(n_prompt[j])
            self.n_admitted += 1

    # -- decode -----------------------------------------------------------

    def _decode_round(self, live: np.ndarray) -> np.ndarray:
        """round_tokens batched steps over the pool with cur / pos / live on
        the device. -> host int32 [pool, round_tokens + 2]: the round's
        tokens (-1 in dead lanes), then the final cur and pos."""
        dev, n = self.asr.device, self.round_tokens
        eos = self.dcfg.eos_token_id
        # device-side budget: a live lane stops at the position where its
        # last budgeted token comes out
        end = self._pos.astype(np.int64) + np.array(
            [s.max_tokens - len(s.tokens) if s is not None else 0
             for s in self._slots])
        pos0 = self._pos.astype(np.int64)
        state = torch.from_numpy(np.stack([self._cur, self._pos, live.astype(np.int32),
                                           end.astype(np.int32)])).to(dev)
        cur, pos, live_d, end_d = state[0], state[1], state[2] == 1, state[3]
        out = torch.full((self.pool, n), -1, dtype=torch.int32, device=dev)
        nxt = torch.empty(self.pool, dtype=torch.int32, device=dev)
        lo = int(pos0.min())
        for i in range(n):
            if self._step is not None:
                hi = int(np.where(live, np.minimum(pos0 + i, end), pos0).max())
                self._step(cur, pos, nxt, (lo, hi))
                new = nxt
            else:
                new = mega_decode_step_batch_ref(
                    self.asr.params["decoder"]["mega"], self.dcfg, cur,
                    pos.numpy(), *self._kv)[0]
            new = torch.where(live_d, new, cur)
            out[:, i] = torch.where(live_d, new, -1)
            pos = torch.where(live_d, pos + 1, pos)
            live_d = live_d & (new != eos) & (pos < end_d)
            cur = new
        return torch.cat([out, cur[:, None], pos[:, None]], dim=1).cpu().numpy()

    def run_round(self) -> list:
        """One decode round over the pool. Returns completed requests as
        [(ticket, TranscribeResult), ...]; their slots are free again."""
        live_mask = np.array([s is not None and not s.finished
                              for s in self._slots])
        done: list = []
        if live_mask.any():
            with span("qwen3.decode"):
                res = self._decode_round(live_mask)
            out = res[:, :self.round_tokens]
            self._cur = res[:, -2].astype(np.int32)
            self._pos = res[:, -1].astype(np.int32)
            self.n_rounds += 1
            self.total_slot_steps += self.pool * self.round_tokens
            eos = self.dcfg.eos_token_id
            for i, slot in enumerate(self._slots):
                if slot is None or slot.finished:
                    continue
                for t in out[i]:
                    t = int(t)
                    self.busy_slot_steps += 1
                    if t == eos:
                        slot.finished = True
                        break
                    slot.tokens.append(t)
                    if len(slot.tokens) >= slot.max_tokens:
                        slot.finished = True
                        break

        if self.on_progress is not None:
            # token-level progress before the completion scan frees slots;
            # a raising callback must not escape run_round (the serving
            # worker would evict every active slot over one bad consumer)
            for slot in self._slots:
                if slot is None or len(slot.tokens) <= slot.notified:
                    continue
                try:
                    self.on_progress(slot.ticket, slot.tokens[slot.notified:])
                except Exception as e:  # noqa: BLE001 - log and continue
                    print(f"engine: on_progress callback raised {e!r} "
                          "(ignored)", file=sys.stderr, flush=True)
                slot.notified = len(slot.tokens)

        for i, slot in enumerate(self._slots):
            if slot is None or not slot.finished:
                continue
            r = TranscribeResult()
            r.tokens = list(slot.tokens)
            with span("qwen3.detokenize"):
                r.text = self.asr.tokenizer.decode(r.tokens)
            r.success = True
            r.t_total_ms = (time.perf_counter() - slot.t_start) * 1e3
            done.append((slot.ticket, r))
            self._slots[i] = None
            self.n_completed += 1
        return done

    def fail_active(self, exc: Exception) -> list:
        """Evict every occupied slot after a decode failure: returns
        [(ticket, exc), ...] so the caller can fail their futures. The pool
        is reallocated and the bookkeeping reset, so the next arrivals
        start clean."""
        out = []
        for i, slot in enumerate(self._slots):
            if slot is not None:
                out.append((slot.ticket, exc))
                self._slots[i] = None
        self._cur[:] = 0
        self._pos[:] = 1
        self._alloc_pool()
        return out

    def stats(self) -> dict:
        return {
            "pool": self.pool,
            "context": self.S,
            "round_tokens": self.round_tokens,
            "rounds": self.n_rounds,
            "admitted": self.n_admitted,
            "completed": self.n_completed,
            "active": self.n_active(),
            "slot_utilization": round(
                self.busy_slot_steps / max(self.total_slot_steps, 1), 3),
        }
