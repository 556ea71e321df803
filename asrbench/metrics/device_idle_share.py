"""1 - the union of every device activity over the traced sub-window, in %."""

from asrbench.layers import idle_share


def read(run):
    return idle_share(run)
