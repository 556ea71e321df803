"""The program's spans in a traced sub-window: the `qwen3.*` ranges that
`qwen3_asr_tpu_torch/runtime/profiler.py::span` opens while a profiler
records (a request, its upload, mel, encoder, prefill or aligner pass,
decode loop, K1 graph capture and text side; the server's queue wait and
batches). `Trace.host` keeps their host side, when the program's thread
was inside each, on the trace's clock. A program that opens no spans (the
trace holds no `qwen3.request`) reads None here, never 0.
"""

from __future__ import annotations

REQUEST = "qwen3.request"


def host_ranges(trace, name: str) -> list[tuple[float, float]]:
    """The host ranges of the spans named `name` that start in the
    window, in order."""
    lo, hi = trace.window
    return sorted((s, e) for n, s, e in trace.host if n == name and lo <= s <= hi)


def per_request(trace, name: str) -> float | None:
    """Spans named `name` in the window over the traced requests; None
    without a trace, a traced request or a qwen3.request span."""
    if trace is None or not trace.requests or not host_ranges(trace, REQUEST):
        return None
    return len(host_ranges(trace, name)) / len(trace.requests)
