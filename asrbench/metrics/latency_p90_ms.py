"""The 90th percentile of the window's request latencies (ms); refused
with fewer than 10 requests beyond it."""

from asrbench.stats import percentile


def read(run):
    return 1e3 * percentile([r.latency for r in run.window.requests], 90)
