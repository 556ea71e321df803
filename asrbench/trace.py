"""The traced sub-window: torch.profiler (CPU and CUDA activity) over a
fixed count of whole requests, reduced to what the per-layer readers need.

- `kernels`: every device activity (kernels, copies, sets) as (name,
  start, end) in seconds on the trace's clock;
- `window`: the span of the harness's own "asrbench.window" range;
- `busy_s`: the union of the device intervals inside the window;
- `breakdown()`: the device operations that took the most time, summed by
  name, and the longest idle gaps of the device inside the window, each
  named by the innermost host operation that covered its middle.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW_SPAN = "asrbench.window"
TOP = 10


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _annotation(ev) -> bool:
    """A range the host marked (record_function), mirrored on the device's
    timeline: no device work of its own."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def union(intervals) -> list[tuple[float, float]]:
    """Merged [start, end] pairs of (start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals, lo: float | None = None, hi: float | None = None) -> float:
    """Seconds covered by the union of intervals, clipped to [lo, hi]."""
    total = 0.0
    for s, e in union(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(0.0, e - s)
    return total


def short_name(name: str) -> str:
    """A kernel's name without its namespace wrappers, return type,
    template and arguments."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].strip()[:96] or name[:96]


class Trace:
    """A finished profile of one sub-window."""

    def __init__(self, prof, requests, batches=None):
        self.requests = requests
        self.batches = batches or []
        from torch.autograd import DeviceType

        kernels, host = [], []
        window = None
        for ev in prof.profiler.kineto_results.events():
            s = _ns(ev, "start") * 1e-9
            e = s + _ns(ev, "duration") * 1e-9
            if ev.name() == WINDOW_SPAN:
                if ev.device_type() != DeviceType.CUDA:
                    window = (s, e)
            elif ev.device_type() == DeviceType.CUDA:
                if not _annotation(ev):
                    kernels.append((ev.name(), s, e))
            else:
                host.append((ev.name(), s, e))
        kernels.sort(key=lambda k: k[1])
        self.kernels = kernels
        self.host = host
        if window is None:
            raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} range")
        self.window = window
        self.window_s = self.window[1] - self.window[0]
        self.busy_s = covered([(s, e) for _, s, e in kernels], *self.window)

    def named(self, names) -> list[tuple[str, float, float]]:
        """The device activities whose short name is one of `names`."""
        names = set(names)
        return [k for k in self.kernels if short_name(k[0]) in names]

    def gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals inside the window."""
        lo, hi = self.window
        out, t = [], lo
        for s, e in union((s, e) for _, s, e in self.kernels):
            if e <= lo or s >= hi:
                continue
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operation running at time t."""
        best = None
        for name, s, e in self.host:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0][:96] if best else "host outside any recorded operation"

    def breakdown(self) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[short_name(name)] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        longest = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), e - s] for s, e in longest]}


def attribute(trace: Trace, own: dict[str, set[str]], shared: set[str]) -> dict[str, list]:
    """Split the activities named in `own` (a set of names per owner) and
    `shared` among the owners: an activity of an owner's own name is its;
    a shared one goes to the owner of the nearest own activity in time.
    -> {owner: [(name, start, end), ...]}."""
    marks = sorted((s, o) for o, names in own.items() for _, s, _ in trace.named(names))
    starts = [s for s, _ in marks]
    out: dict[str, list] = {o: list(trace.named(names)) for o, names in own.items()}
    for k in trace.named(shared):
        if not marks:
            break
        i = bisect.bisect_left(starts, k[1])
        near = [j for j in (i - 1, i) if 0 <= j < len(marks)]
        j = min(near, key=lambda j: abs(starts[j] - k[1]))
        out[marks[j][1]].append(k)
    return out
