"""Log-mel spectrogram frontend on the device.

Port of qwen3_asr_tpu/audio/mel.py (`generate_mel_filters`, `reflect_pad`,
`num_mel_frames`, `_dft_tables` copied as numpy; `_mel_device` and
`_mel_device_batch` as `mel_device`; `log_mel_spectrogram_padded` and
`log_mel_spectrogram_padded_batch`, the bucketed frontends). Semantics: reflect-pad n_fft/2 -> periodic Hann(400), hop 160
-> real DFT power (201 bins, as two f32 matmuls with TF32 off) -> Slaney
mel filterbank -> log10 -> clamp to (max - 8) -> (x + 4) / 4.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import HOP_LENGTH, N_FFT, N_MELS, SAMPLE_RATE
from qwen3_asr_tpu_torch.ops.support import full_f32

_LOG_FLOOR = 1e-10


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (np.power(10.0, np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def generate_mel_filters(
    n_mels: int = N_MELS, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """HTK-scale triangular filterbank with Slaney normalization.
    Returns float32 [n_mels, n_fft//2 + 1]."""
    n_bins = 1 + n_fft // 2
    fmax = sample_rate / 2.0
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_pts = (n_fft + 1) * hz_pts / sample_rate

    k = np.arange(n_bins, dtype=np.float64)[None, :]
    left = bin_pts[:-2][:, None]
    center = bin_pts[1:-1][:, None]
    right = bin_pts[2:][:, None]

    up = (k - left) / (center - left)
    down = (right - k) / (right - center)
    weights = np.where((k >= left) & (k <= center), up, 0.0)
    weights = np.where((k >= center) & (k <= right), down, weights)
    weights = np.maximum(weights, 0.0)

    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_window(n_fft: int = N_FFT) -> np.ndarray:
    i = np.arange(n_fft, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * i / n_fft))


def reflect_pad(samples: np.ndarray, pad: int = N_FFT // 2) -> np.ndarray:
    """Reflect padding without repeating the edge sample; reflections that
    fall outside a short signal are 0."""
    n = len(samples)
    out = np.zeros(n + 2 * pad, dtype=samples.dtype)
    out[pad : pad + n] = samples
    left_src = pad - np.arange(pad)
    valid = left_src < n
    out[:pad][valid] = samples[left_src[valid]]
    right_src = n - 2 - np.arange(pad)
    valid = right_src >= 0
    out[pad + n :][valid] = samples[right_src[valid]]
    return out


def num_mel_frames(n_samples: int) -> int:
    """Output mel frames for a raw sample count (total frames - 1)."""
    padded = n_samples + 2 * (N_FFT // 2)
    total = (padded - N_FFT) // HOP_LENGTH + 1
    return total - 1


@functools.cache
def _dft_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hann[400], cos[400,201], sin[400,201]) as float32 host constants."""
    k = np.arange(1 + N_FFT // 2, dtype=np.float64)
    n = np.arange(N_FFT, dtype=np.float64)
    angle = 2.0 * np.pi * np.outer(n, k) / N_FFT
    return (
        _hann_window().astype(np.float32),
        np.cos(angle).astype(np.float32),
        np.sin(angle).astype(np.float32),
    )


@functools.cache
def _dft_device(device: torch.device) -> tuple[torch.Tensor, ...]:
    """The DFT tables on `device`, uploaded once per device."""
    return tuple(torch.from_numpy(a).to(device) for a in _dft_tables())


def filters_t(filters: np.ndarray, device) -> torch.Tensor:
    """[n_mels, 201] host filterbank -> [201, n_mels] f32 on `device`."""
    return torch.from_numpy(np.ascontiguousarray(filters.T)).to(device)


def mel_device(padded: torch.Tensor, filters_t: torch.Tensor,
               n_frames: int, n_valid=None) -> torch.Tensor:
    """`padded` [(n_frames + 2) * HOP] int16 or f32 (int16 is scaled by
    1/32768 on the device), or a batch [B, (n_frames + 2) * HOP] -> log-mel
    [n_frames, n_mels] f32 (or [B, n_frames, n_mels]). Frames are rows
    [i, i+1] of the [n_frames + 2, HOP] view plus the first 80 samples of
    row i+2, as in the JAX package; the max that floors the log is taken
    per item. `n_valid` (an int, or [B] int32 for a batch): frames at index
    >= n_valid are set to exactly 0.0, the zero-fill the bucketed encoder's
    chunk padding expects."""
    hann, cos_t, sin_t = _dft_device(padded.device)
    if padded.dtype == torch.int16:
        padded = padded.float() / 32768.0
    rows = padded.reshape(*padded.shape[:-1], n_frames + 2, HOP_LENGTH)
    frames = torch.cat([rows[..., :n_frames, :], rows[..., 1:n_frames + 1, :],
                        rows[..., 2:n_frames + 2, :N_FFT - 2 * HOP_LENGTH]],
                       dim=-1)
    frames = frames * hann
    with full_f32():
        re = frames @ cos_t
        im = frames @ sin_t
        power = re * re + im * im
        mel = power @ filters_t
    logmel = torch.log10(torch.clamp(mel, min=_LOG_FLOOR))
    mmax = logmel.amax(dim=(-2, -1), keepdim=True) - 8.0
    out = (torch.maximum(logmel, mmax) + 4.0) / 4.0
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, device=out.device).reshape(-1, 1, 1)
        idx = torch.arange(n_frames, device=out.device)[None, :, None]
        out = torch.where(idx < nv, out, torch.zeros((), device=out.device))
        out = out.reshape(*padded.shape[:-1], n_frames, -1)
    return out


def _padded_buffer(samples: np.ndarray, n_frames: int, dev_frames: int,
                   dtype) -> np.ndarray:
    """Reflect-padded PCM in a zeroed [(dev_frames + 2) * HOP] buffer,
    holding only the samples the first n_frames frames can see (frames
    past them must stay all-zero so they cannot move the max)."""
    padded = reflect_pad(samples.astype(dtype))
    buf = np.zeros((dev_frames + 2) * HOP_LENGTH, dtype=dtype)
    n_copy = min((n_frames - 1) * HOP_LENGTH + N_FFT, len(padded), len(buf))
    buf[:n_copy] = padded[:n_copy]
    return buf


def _as_pcm(samples) -> np.ndarray:
    samples = np.asarray(samples)
    return samples if samples.dtype == np.int16 else samples.astype(np.float32)


def log_mel_spectrogram_padded_batch(samples_list, filters_t: torch.Tensor,
                                     bucket: int
                                     ) -> tuple[torch.Tensor, list[int]]:
    """Batched bucketed log-mel -> ([B, n_mels, F_b] on the device of
    `filters_t`, true frame counts). F_b is the largest item's frame count
    rounded up to `bucket`; one upload and one mel pass for the batch.
    Frames past an item's true count are 0.0."""
    prepped = [_as_pcm(s) for s in samples_list]
    n_frames = [num_mel_frames(len(s)) for s in prepped]
    if min(n_frames) <= 0 or bucket <= 0:
        raise ValueError(f"need n_frames > 0 and bucket > 0 "
                         f"(got {n_frames}, {bucket})")
    F_b = -(-max(n_frames) // bucket) * bucket
    dt = (np.int16 if all(s.dtype == np.int16 for s in prepped)
          else np.float32)
    buf = np.stack([
        _padded_buffer(s.astype(np.float32) / 32768.0
                       if s.dtype == np.int16 and dt == np.float32 else s,
                       nf, F_b, dt)
        for s, nf in zip(prepped, n_frames)])
    dev = filters_t.device
    out = mel_device(torch.from_numpy(buf).to(dev), filters_t, F_b,
                     torch.tensor(n_frames, dtype=torch.int32, device=dev))
    return out.transpose(1, 2), n_frames


def log_mel_spectrogram_padded(samples, filters_t: torch.Tensor,
                               bucket: int) -> tuple[torch.Tensor, int]:
    """Bucketed log-mel of one utterance -> ([n_mels, F_b] on the device,
    true n_frames), F_b = n_frames rounded up to `bucket`, frames past the
    true count 0.0 (not sliced off: the padded shape is what the bucketed
    encoder takes)."""
    mel, n_frames = log_mel_spectrogram_padded_batch([samples], filters_t,
                                                     bucket)
    return mel[0], n_frames[0]
