"""K3 (the batched decode step): the least time of the traced batches'
decode steps over K3's device time, in %."""

from asrbench.layers import decode_roofline


def read(run):
    return decode_roofline(run, "k3")
