"""End-to-end transcription and alignment of one utterance: PCM in,
tokens or timestamp classes out.

Port of qwen3_asr_tpu/models/e2e.py:35-211 (`expected_n_audio`,
`PreparedPCM` / `prepare_pcm`, `_pad_pcm`, `transcribe_fused`,
`align_fused`): mel, the encoder, the prompt splice, then the prefill and
the greedy loop (transcription) or the aligner's one causal pass and the
argmax of its classify head (alignment) run on the device after one upload
of the padded PCM and the prompt, and the result comes back in one fetch
(plus the greedy loop's EOS checks). A `PreparedPCM` is the padded PCM
uploaded once; the combined mode's two legs share it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import AlignerModelConfig, ASRModelConfig
from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt
from qwen3_asr_tpu_torch.audio.mel import _as_pcm, _padded_buffer, mel_device, num_mel_frames
from qwen3_asr_tpu_torch.models.encoder import chunk_output_len, encode
from qwen3_asr_tpu_torch.models.generate import generate_greedy
from qwen3_asr_tpu_torch.runtime.profiler import span


def expected_n_audio(n_frames: int, chunk: int = 100) -> int:
    n_chunks = -(-n_frames // chunk)
    return chunk_output_len(chunk) * (n_chunks - 1) + chunk_output_len(
        n_frames - (n_chunks - 1) * chunk)


def _pad_pcm(samples: np.ndarray) -> tuple[np.ndarray, int]:
    """Reflect-pad PCM into the fixed mel framing buffer (host)."""
    n_frames = num_mel_frames(len(samples))
    return _padded_buffer(samples, n_frames, n_frames, samples.dtype), n_frames


@dataclasses.dataclass
class PreparedPCM:
    """PCM padded into the mel framing buffer and uploaded once, for both
    legs of the combined mode (the ASR and the aligner share the mel
    front end: 16 kHz, hop 160, n_fft 400)."""

    samples: np.ndarray   # the host samples (int16 or float32)
    buf: torch.Tensor     # [(n_frames + 2) * HOP] padded PCM on the device
    n_frames: int

    def __len__(self) -> int:   # the duration contract: len(x) / SAMPLE_RATE
        return len(self.samples)


def prepare_pcm(samples, device) -> PreparedPCM:
    """Pad the PCM and upload it to `device` once, for transcribe_fused and
    align_fused."""
    with span("qwen3.upload"):
        samples = _as_pcm(samples)
        buf, n_frames = _pad_pcm(samples)
        return PreparedPCM(samples, torch.from_numpy(buf).to(device), n_frames)


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
                     cache_dtype: torch.dtype = torch.bfloat16
                     ) -> tuple[np.ndarray, int]:
    """int16 or float PCM, or a PreparedPCM, -> (tokens [max_tokens],
    n_kept) on the device of `filters_t` ([201, n_mels] f32). cache_dtype: the KV cache's dtype, as
    generate_greedy takes it: bf16 by default, as in the reference, int8,
    or generate.INT4_KV (the decode pack's int4 cache, packed from the
    prefill's int8 rows; int8 without a pack)."""
    with span("qwen3.upload"):
        buf_d, n_frames, buf = _staged(samples)
        n_audio = expected_n_audio(n_frames)
        prompt = build_asr_prompt(n_audio, cfg.decoder, system_prompt_tokens)
        offset = audio_start_pos(prompt, cfg.decoder)
        if buf_d is None:
            buf_d, prompt_d = upload([buf, np.asarray(prompt, np.int32)],
                                     filters_t.device)
        else:
            prompt_d = torch.from_numpy(np.asarray(prompt, np.int32)).to(buf_d.device)
    with span("qwen3.mel"):
        mel = mel_device(buf_d, filters_t, n_frames).T          # [n_mels, N]
    with span("qwen3.encode"):
        feats = encode(params["encoder"], cfg.encoder, mel, n_frames)
    return generate_greedy(params["decoder"], cfg.decoder, prompt_d,
                           len(prompt), feats, feats.shape[0], offset,
                           max_tokens, cache_dtype)


def _staged(samples):
    """(the padded PCM on the device or None, n_frames, the host buffer or
    None) of a PreparedPCM or of host samples."""
    if isinstance(samples, PreparedPCM):
        return samples.buf, samples.n_frames, None
    buf, n_frames = _pad_pcm(_as_pcm(samples))
    return None, n_frames, buf


def pad_prompts(prompts: list[list[int]], cfg, bucket: int = 128) -> np.ndarray:
    """The aligner's prompts left-aligned in int32 [B, P], P the longest
    rounded up to a multiple of `bucket` rows, padded with pad_token_id %
    vocab_size."""
    P = -(-max(len(p) for p in prompts) // bucket) * bucket
    toks = np.full((len(prompts), P), cfg.pad_token_id % cfg.vocab_size, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    return toks


def align_fused(params: dict, cfg: AlignerModelConfig, samples,
                filters_t: torch.Tensor, input_tokens: list[int],
                audio_offset: int = 1) -> np.ndarray:
    """Forced alignment in one pass on the device of `filters_t`: PCM (or a
    PreparedPCM) and the aligner's whole prompt -> the argmax class at every
    real prompt position, int32 [len(input_tokens)], in one fetch. Mel, the
    windowed encoder, the causal pass over the prompt bucketed to 128 rows
    and the classify head's argmax all stay on the device."""
    from qwen3_asr_tpu_torch.models.decoder import classify_logits
    from qwen3_asr_tpu_torch.models.generate import nar_forward

    with span("qwen3.upload"):
        buf_d, n_frames, buf = _staged(samples)
        n_real = len(input_tokens)
        toks = pad_prompts([input_tokens], cfg.decoder)[0]
        if buf_d is None:
            buf_d, toks_d = upload([buf, toks], filters_t.device)
        else:
            toks_d = torch.from_numpy(toks).to(buf_d.device)
    with span("qwen3.mel"):
        mel = mel_device(buf_d, filters_t, n_frames).T
    with span("qwen3.encode"):
        feats = encode(params["encoder"], cfg.encoder, mel, n_frames)
    with span("qwen3.nar"):
        h = nar_forward(params["decoder"], cfg.decoder, toks_d, feats, feats.shape[0],
                        audio_offset, n_valid=n_real)
        pred = torch.argmax(classify_logits(params["decoder"], cfg.decoder, h[:n_real]),
                            dim=-1)
        return pred.to(torch.int32).cpu().numpy()
