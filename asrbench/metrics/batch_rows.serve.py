"""Requests per batch the server ran over the window: ASRServer's
n_served / n_batches, differences across the window."""


def read(run):
    c = run.counters
    if not c.get("n_batches"):
        return None
    return c["n_served"] / c["n_batches"]
