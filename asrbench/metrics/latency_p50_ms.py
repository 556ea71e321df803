"""Median request latency (ms) over every request of the window: closed
loop from send to result, open loop from due to result; a failed request
counts as missing."""

from asrbench.stats import percentile


def read(run):
    return 1e3 * percentile([r.latency for r in run.window.requests], 50)
