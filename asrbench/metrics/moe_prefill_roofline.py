"""The prefill's grouped expert products (gate-up, down): their least time
over their device time, in %. The least time of a traced request's
prefill is the larger of the touched experts' bytes (its counter
`experts_touched`, summed over the layers) at 3.35 TB/s and its routed
pairs' int8 operations at 1,979 TOP/s (the family's
`moe_prefill_least`); the device time is the union of the two kernels'
activities. None where the trace holds no such kernel, or the door
records no counters with its outputs."""

from asrbench.trace import covered

KERNELS = {"moe_gate_up", "moe_down"}


def read(run):
    t, fam = run.trace, run.family
    if t is None or not hasattr(fam, "moe_prefill_least"):
        return None
    spans = [(s, e) for _, s, e in t.named(KERNELS)]
    counts = [getattr(r.output, "moe", None) for r in t.requests if r.ok]
    if not spans or not counts or None in counts:
        return None
    least = sum(fam.moe_prefill_least(run.config, c["experts_touched"], c["pairs"])
                for c in counts)
    return 100.0 * least / covered(spans)
