"""End-to-end transcription of one utterance: PCM in, tokens out.

Port of qwen3_asr_tpu/models/e2e.py:35-211 (`expected_n_audio`, `_pad_pcm`,
`transcribe_fused`): mel, the encoder, the prompt splice, the prefill and
the greedy loop run on the device after one upload of the padded PCM and
the prompt, and the tokens come back in one fetch (plus the loop's EOS
checks).
"""

from __future__ import annotations

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import ASRModelConfig
from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt
from qwen3_asr_tpu_torch.audio.mel import _padded_buffer, mel_device, num_mel_frames
from qwen3_asr_tpu_torch.models.encoder import chunk_output_len, encode
from qwen3_asr_tpu_torch.models.generate import generate_greedy


def expected_n_audio(n_frames: int, chunk: int = 100) -> int:
    n_chunks = -(-n_frames // chunk)
    return chunk_output_len(chunk) * (n_chunks - 1) + chunk_output_len(
        n_frames - (n_chunks - 1) * chunk)


def _pad_pcm(samples: np.ndarray) -> tuple[np.ndarray, int]:
    """Reflect-pad PCM into the fixed mel framing buffer (host)."""
    n_frames = num_mel_frames(len(samples))
    return _padded_buffer(samples, n_frames, n_frames, samples.dtype), n_frames


def upload(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """Copy several host arrays to `device` in ONE transfer: pack their bytes
    into one buffer (16-byte aligned pieces) and view the pieces back."""
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16
    buf = np.zeros(total, np.uint8)
    for a, o in zip(arrays, offs):
        buf[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
    dev = torch.from_numpy(buf).to(device)
    out = []
    for a, o in zip(arrays, offs):
        t = dev[o:o + a.nbytes].view(getattr(torch, a.dtype.name))
        out.append(t.reshape(a.shape))
    return out


def transcribe_fused(params: dict, cfg: ASRModelConfig, samples: np.ndarray,
                     filters_t: torch.Tensor, max_tokens: int,
                     system_prompt_tokens=None,
                     cache_dtype: torch.dtype | None = None) -> tuple[np.ndarray, int]:
    """int16 or float PCM -> (tokens [max_tokens], n_kept) on the device of
    `filters_t` ([201, n_mels] f32). cache_dtype: the KV cache's dtype, as
    generate_greedy takes it (None: what the tree's decode step defaults to)."""
    samples = np.asarray(samples)
    if samples.dtype != np.int16:
        samples = samples.astype(np.float32)
    buf, n_frames = _pad_pcm(samples)
    n_audio = expected_n_audio(n_frames)
    prompt = build_asr_prompt(n_audio, cfg.decoder, system_prompt_tokens)
    offset = audio_start_pos(prompt, cfg.decoder)
    buf_d, prompt_d = upload([buf, np.asarray(prompt, np.int32)],
                             filters_t.device)
    mel = mel_device(buf_d, filters_t, n_frames).T          # [n_mels, N]
    feats = encode(params["encoder"], cfg.encoder, mel, n_frames)
    return generate_greedy(params["decoder"], cfg.decoder, prompt_d,
                           len(prompt), feats, feats.shape[0], offset,
                           max_tokens, cache_dtype)
