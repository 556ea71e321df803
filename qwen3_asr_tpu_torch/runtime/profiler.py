"""Named-section wall-clock profiler: the port's own copy of
qwen3_asr_tpu/runtime/profiler.py (host-only code, kept here so that the
port imports nothing of the JAX package).

Same shape as the reference's TimingProfiler (timing.h:12-78): named section
totals/counts/averages plus a report table; always available (no compile
gate). Device work is fenced with `torch.cuda.synchronize` by callers.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class _Section:
    total_us: float = 0.0
    count: int = 0


@dataclass
class Profiler:
    sections: dict[str, _Section] = field(default_factory=dict)
    enabled: bool = True

    def record(self, name: str, us: float) -> None:
        if not self.enabled:
            return
        s = self.sections.setdefault(name, _Section())
        s.total_us += us
        s.count += 1

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1e6)

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


def timer(name: str):
    """Module-level convenience: `with timer("decode.token"): ...`"""
    return profiler(name)
