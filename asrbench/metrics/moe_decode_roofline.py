"""The MoE decode step's expert kernels (router, routed gate-up and down
GEMVs): the traced decode steps' expert bytes (each layer's k routed
experts' int8 codes and scales, and its router, at 3.35 TB/s; the
family's `moe_decode_bytes`) over the union of those kernels' device time,
in %. None where the trace holds no such kernel or the family has no
experts."""

from asrbench import work
from asrbench.trace import covered

KERNELS = {"moe_router", "moe_gemv_gu", "moe_gemv_down"}


def read(run):
    t, fam = run.trace, run.family
    if t is None or run.kind != "asr" or not hasattr(fam, "moe_decode_bytes"):
        return None
    spans = [(s, e) for _, s, e in t.named(KERNELS)]
    steps = sum(len(fam.decode_positions(run.config, r)) for r in t.requests if r.ok)
    if not spans or not steps:
        return None
    least = steps * fam.moe_decode_bytes(run.config) / work.HBM_BPS
    return 100.0 * least / covered(spans)
