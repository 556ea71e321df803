"""Log-mel spectrogram of 16 kHz PCM in float32: reflect padding by n_fft / 2,
a periodic Hann window of 400 samples at hop 160, the power spectrum, a
Slaney-normalised triangular filter bank on the HTK mel scale, log10,
clamped to 8 below the utterance's maximum, then (x + 4) / 4.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 128


def mel_filters(n_mels: int = N_MELS, n_fft: int = N_FFT,
                sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Triangular filters [n_mels, n_fft // 2 + 1] on the HTK mel scale,
    each scaled by 2 / (its band's width in Hz)."""
    def hz_to_mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)

    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2))
    bins = (n_fft + 1) * hz / sample_rate
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    lo, mid, hi = bins[:-2, None], bins[1:-1, None], bins[2:, None]
    up = np.where((k >= lo) & (k <= mid), (k - lo) / (mid - lo), 0.0)
    w = np.where((k >= mid) & (k <= hi), (hi - k) / (hi - mid), up)
    w = np.maximum(w, 0.0) * (2.0 / (hz[2:] - hz[:-2]))[:, None]
    return w.astype(np.float32)


def n_mel_frames(n_samples: int) -> int:
    """Frames of an utterance of n_samples: the centred STFT's frames
    less the last one."""
    return n_samples // HOP


def log_mel(pcm: np.ndarray, device) -> torch.Tensor:
    """int16 PCM -> log-mel [N_MELS, n_frames] float32 on `device`."""
    x = torch.from_numpy(np.asarray(pcm, np.int16).astype(np.float32) / 32768.0).to(device)
    n_frames = n_mel_frames(x.shape[0])
    x = torch.nn.functional.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, N_FFT, HOP)[:n_frames]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=device)
    spec = torch.fft.rfft(frames * window.float(), dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    filt = torch.from_numpy(mel_filters()).to(device)
    mel = power @ filt.T
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    logmel = torch.maximum(logmel, logmel.max() - 8.0)
    return ((logmel + 4.0) / 4.0).T.contiguous()
