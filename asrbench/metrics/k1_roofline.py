"""K1 (the one-request decode step): the least time of the traced decode
steps over K1's device time, in %."""

from asrbench.layers import decode_roofline


def read(run):
    return decode_roofline(run, "k1")
