"""Named spans over the port's stages, and the section table of `--profile`.

`span("qwen3.<stage>")` marks one stage of a request (the upload, the
log-mel, the encoder, the prefill or the aligner's pass, the decode loop, a
K1 graph capture, the detokenizer, the server's queue wait and batch). It
is a context manager that does what is asked of it and nothing else:

- while a `torch.profiler` session records (`--trace-dir`, the benchmark's
  traced window), it opens a `record_function` range of that name, which
  the profiler puts on the device trace's clock and mirrors onto the CUDA
  timeline over the kernels launched inside it;
- with `profiler.enabled` (the CLI's `--profile`), it adds its host
  milliseconds to the section table that `profiler.report()` prints;
- otherwise it returns one shared no-op context: no range, no clock read,
  no allocation.

`span(name, timed=True)` always reads the host clock, for a caller that
fills a result's timing field from the span (`.ms` after the block); the
staged paths, which synchronize after each stage, do so.

The section table keeps the shape of the reference's TimingProfiler
(timing.h:12-78): totals, counts and averages per name.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch.autograd.profiler as _autograd_profiler


@dataclass
class _Section:
    total_us: float = 0.0
    count: int = 0


@dataclass
class Profiler:
    sections: dict[str, _Section] = field(default_factory=dict)
    enabled: bool = False

    def record(self, name: str, us: float) -> None:
        if not self.enabled:
            return
        s = self.sections.setdefault(name, _Section())
        s.total_us += us
        s.count += 1

    def report(self) -> str:
        lines = [
            "=== Timing Profile ===",
            f"{'Section':<40} {'Total (ms)':>12} {'Calls':>8} {'Avg (ms)':>10}",
        ]
        for name in sorted(self.sections):
            s = self.sections[name]
            lines.append(
                f"{name:<40} {s.total_us / 1000:>12.2f} {s.count:>8} "
                f"{s.total_us / 1000 / max(s.count, 1):>10.3f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.sections.clear()


profiler = Profiler()

_NULL = contextlib.nullcontext()


class _Span:
    """An open span: a profiler range while one records, and the host
    milliseconds (`ms`) once the block ends."""

    __slots__ = ("name", "ms", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.ms = 0.0
        self._range = None

    def __enter__(self) -> _Span:
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.ms = (time.perf_counter() - self._t0) * 1e3
        if self._range is not None:
            self._range.__exit__(*exc)
        profiler.record(self.name, self.ms * 1e3)
        return False


def span(name: str, timed: bool = False):
    """A span named `name` ("qwen3.<stage>"); see the module's doc."""
    if timed or profiler.enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _NULL
