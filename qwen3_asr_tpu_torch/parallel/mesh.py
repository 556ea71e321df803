"""Batched transcription's decode on one GPU.

Port of qwen3_asr_tpu/parallel/mesh.py::batched_transcribe_step (:182-335)
at dp = 1, tp = 1: the device mesh, the sharding rules and the dp-sharded
kernel are the multi-chip part and are not ported here. It picks the
batched decode for the tree and the cache, as the reference does, with one
change: a decode pack over a bf16 cache runs the batched decode step (K3)
too, where the reference takes its vmapped XLA step, because there the B
bf16 slabs would not fit a TPU core's VMEM; on the card they cost only their
bytes, and K3's rows are the single-sequence step's (K1 bf16), so the KV
numerics still follow the caller's setting.

| tree / cache                  | route                                     |
|-------------------------------|-------------------------------------------|
| decode pack, int8 or bf16     | generate_greedy_batch_mega (K3), chunks    |
|                               | of <= MAX_BATCH (16) sequences             |
| decode pack, int4             | the same over int8 (K3 has no int4 cache)  |
| no pack (Q8_0, dense leaves)  | generate_greedy_batch: the per-layer step  |
|                               | at B rows (K4 batched, K5-K7 at T = B)     |
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.models.generate import (
    INT4_KV,
    generate_greedy_batch,
    generate_greedy_batch_mega,
)
from qwen3_asr_tpu_torch.ops.megakernel_batch import MAX_BATCH


def batched_transcribe_step(dec_params: dict, cfg: DecoderConfig, tokens: torch.Tensor,
                            n_prompt, audio: torch.Tensor, n_audio, audio_offset: int,
                            max_tokens: int, cache_dtype: torch.dtype = torch.bfloat16
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy generation for a batch of prompts: tokens [B, P] int32 on the
    model's device (left-aligned, padded), n_prompt / n_audio host sequences
    of B ints, audio [B, N, hidden] (the first n_audio[b] rows spliced over
    row b's audio_pad rows at audio_offset). cache_dtype: torch.bfloat16,
    torch.int8 or INT4_KV (which runs as int8). -> (out [B, max_tokens]
    int32, n_kept [B]) on the host; tokens at index >= n_kept[b] are
    filler."""
    if cache_dtype == INT4_KV:
        cache_dtype = torch.int8
    n_prompt = np.asarray(n_prompt, np.int64).reshape(-1)
    n_audio = np.asarray(n_audio, np.int64).reshape(-1)
    args = (audio_offset, max_tokens, cache_dtype)
    if "mega" not in dec_params:
        return generate_greedy_batch(dec_params, cfg, tokens, n_prompt, audio, n_audio,
                                     *args)
    outs, kept = [], []
    for c in range(0, tokens.shape[0], MAX_BATCH):
        e = c + MAX_BATCH
        o, k = generate_greedy_batch_mega(dec_params, cfg, tokens[c:e], n_prompt[c:e],
                                          audio[c:e], n_audio[c:e], *args)
        outs.append(o)
        kept.append(k)
    return np.concatenate(outs), np.concatenate(kept)
