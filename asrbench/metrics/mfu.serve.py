"""The model's operations for the requests of the traced sub-window over
its seconds x 989 TFLOP/s (H100 SXM, bf16 dense), in %."""

from asrbench.layers import mfu


def read(run):
    return mfu(run)
