"""What the per-layer readers share: the model's share of the chip's peak
over the traced sub-window, a decode kernel's share of its roofline, and
the device's idle share. The operations and bytes come from the run's
family (`request_ops`, `decode_positions`, `step_work`), the peaks from
`work.py`. Each returns None where its trace holds nothing to read."""

from __future__ import annotations

from asrbench import work
from asrbench.trace import attribute, covered

K1_OWN = {"gemv_i8", "gemv_i4"}          # K1's products
K3_OWN = {"prod_batch"}                  # K3's products
DECODE_SHARED = {"norm_quant", "attn_step", "argmax_partial", "argmax_final"}


def mfu(run) -> float | None:
    """The operations of the traced requests over the traced window's
    seconds at the bf16 peak, in %."""
    t = run.trace
    done = [r for r in t.requests if r.ok] if t else []
    if not done or t.window_s <= 0:
        return None
    ops = sum(run.family.request_ops(run.config, run.kind, r) for r in done)
    return 100.0 * ops / (t.window_s * work.BF16_FLOPS)


def decode_roofline(run, kernel: str) -> float | None:
    """"k1" or "k3": the least time of the traced window's decode steps of
    that kernel over its device time (the union of its activities; the
    step's shared kernels go to the nearest product), in %. K1 serves a
    request alone, K3 a batch of two or more."""
    t = run.trace
    if t is None or run.kind != "asr":
        return None
    parts = attribute(t, {"k1": K1_OWN, "k3": K3_OWN}, DECODE_SHARED)
    spans = [(s, e) for _, s, e in parts[kernel]]
    if not spans:
        return None
    reqs = {r.seq: r for r in t.requests if r.ok}
    if t.batches:
        groups = [[reqs[s] for s in b if s in reqs] for b in t.batches]
    else:
        groups = [[r] for r in reqs.values()]
    least = 0.0
    for rows in groups:
        if not rows or (len(rows) == 1) != (kernel == "k1"):
            continue
        pos = [run.family.decode_positions(run.config, r) for r in rows]
        for i in range(min(len(p) for p in pos)):
            step = run.family.step_work(run.config, [p[i] for p in pos], run.kv)
            least += work.bound(*step, work.INT8_OPS)
    if least == 0.0:
        return None
    return 100.0 * least / covered(spans)


def idle_share(run) -> float | None:
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
