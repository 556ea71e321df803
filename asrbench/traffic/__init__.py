"""The one traffic generator: it reads a mix file (`asrbench/workloads/
<traffic>.json`) and makes the requests, their audio and their schedule
from the seed.

A mix gives its audio lengths as a range, `audio_s: [lo, hi]`, split into
`sizes` equal strata whose mid-points are the lengths every seed uses: the
seed draws the order, not the set, and each length is sent next to its
mirror in the range, so two seeds put the same work into a window. Each
request decodes `max_tokens` (round(tokens_per_audio_s x seconds), or a
fixed `max_tokens`) or aligns round(words_per_audio_s x seconds) words. The audio is 16 kHz
int16 PCM, one seeded signal that each length slices at a seeded offset:
"syllables" of 60-240 ms, each a voiced tone (seeded pitch 90-400 Hz with
two harmonics, seeded loudness) or a pause, over seeded Gaussian noise. It
changes every few frames, so a front end that shifts, drops or mixes up
frames changes what the model hears.

Loops (`loop`):
- "closed": one client sends the next request when the last one returned,
  the lengths in seeded permutations of the set, one after another;
- "poisson": open, independent users arriving at `rate_per_s`: the gaps
  are the exponential distribution's quantiles at (k + 0.5) / N for N =
  round(rate x seconds), in a seeded order, so every seed offers the same
  load.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SAMPLE_RATE = 16000
SEED_MOD = 2 ** 63
_ORDER, _AUDIO, _OFFSETS, _GAPS, _TRACE = range(5)   # the seed's streams


@dataclasses.dataclass
class Request:
    """One request: its index in the run, its length's index in the set,
    its shape, and when it was due, sent and done (seconds from the start
    of its window; t_due is None in a closed loop)."""

    seq: int
    kind: int
    n_samples: int
    max_tokens: int = 0
    n_words: int = 0
    t_due: float | None = None
    t_sent: float = 0.0
    t_done: float | None = None
    error: str = ""
    output: object = None

    @property
    def seconds(self) -> float:
        return self.n_samples / SAMPLE_RATE

    @property
    def ok(self) -> bool:
        return self.t_done is not None and not self.error

    @property
    def latency(self) -> float:
        """From due (open loop) or sent (closed loop) to done; inf for a
        request that failed or never came back."""
        if not self.ok:
            return float("inf")
        start = self.t_sent if self.t_due is None else self.t_due
        return self.t_done - start


def syllables(rng: np.random.Generator, n: int) -> np.ndarray:
    """n samples of int16 PCM: syllables of 60-240 ms, each a tone of
    seeded pitch (90-400 Hz, with its second and third harmonics) at a
    seeded loudness, about one in six a pause, over Gaussian noise."""
    lo, hi = int(0.06 * SAMPLE_RATE), int(0.24 * SAMPLE_RATE)
    lens = rng.integers(lo, hi + 1, size=n // lo + 1)
    k = int(np.searchsorted(np.cumsum(lens), n)) + 1
    lens = lens[:k]
    pitch = np.repeat(rng.uniform(90.0, 400.0, k), lens)[:n]
    loud = np.repeat(rng.uniform(0.05, 0.4, k) * (rng.random(k) > 1 / 6), lens)[:n]
    phase = 2 * np.pi * np.cumsum(pitch) / SAMPLE_RATE
    voiced = (np.sin(phase) + 0.5 * np.sin(2 * phase) + 0.25 * np.sin(3 * phase)) / 1.75
    wave = loud * voiced + 0.05 * rng.standard_normal(n)
    return (wave * 32768.0).clip(-32768, 32767).astype(np.int16)


class Plan:
    """The requests of one mix under one seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = seed % SEED_MOD
        lo, hi = mix["audio_s"]
        k = mix["sizes"]
        self.lengths = [lo + (hi - lo) * (i + 0.5) / k for i in range(k)]
        self.n_samples = [int(round(s * SAMPLE_RATE)) for s in self.lengths]
        n = int((hi + 2) * SAMPLE_RATE)
        self._base = syllables(self._rng(_AUDIO), n)
        offs = self._rng(_OFFSETS)
        self._offsets = [int(offs.integers(0, n - m + 1)) for m in self.n_samples]
        self._pcm: dict[int, np.ndarray] = {}

    def _rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream])

    def request(self, seq: int, kind: int, t_due: float | None = None) -> Request:
        s, m = self.lengths[kind], self.mix
        tokens = (int(round(m["tokens_per_audio_s"] * s)) if "tokens_per_audio_s" in m
                  else int(m.get("max_tokens", 0)))
        words = int(round(m["words_per_audio_s"] * s)) if "words_per_audio_s" in m else 0
        return Request(seq, kind, self.n_samples[kind], tokens, words, t_due)

    def pcm(self, req: Request) -> np.ndarray:
        """The request's audio, int16 (one array per length, made once)."""
        if req.kind not in self._pcm:
            o = self._offsets[req.kind]
            self._pcm[req.kind] = self._base[o:o + req.n_samples].copy()
        return self._pcm[req.kind]

    def kinds(self, stream: int = _ORDER):
        """Length indices without end: seeded permutations of the set, in
        which each length k comes next to its mirror, sizes - 1 - k, so any
        stretch of the sequence averages the set's mean length."""
        rng = self._rng(stream)
        k = len(self.lengths)
        pairs = [(i, k - 1 - i) for i in range(k // 2)] + ([(k // 2,)] if k % 2 else [])
        while True:
            for j in rng.permutation(len(pairs)):
                pair = pairs[int(j)]
                yield from (pair if rng.random() < 0.5 else pair[::-1])

    def closed(self, stream: int = _ORDER):
        """Requests without end, for a closed loop."""
        for seq, kind in enumerate(self.kinds(stream)):
            yield self.request(seq, kind)

    def schedule(self, seconds: float, stream: int = _GAPS) -> list[Request]:
        """The open loop's requests over `seconds`, each with its due time."""
        rate = float(self.mix["rate_per_s"])
        n = max(1, int(round(rate * seconds)))
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
        gaps = self._rng(stream).permutation(gaps)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        kinds = self.kinds(stream + 100)
        return [self.request(i, next(kinds), float(t)) for i, t in enumerate(due)]

    def warm_requests(self) -> list[Request]:
        """One request at the shortest and one at the longest length."""
        return [self.request(-1, 0), self.request(-2, len(self.lengths) - 1)]


TRACE_STREAM = _TRACE
