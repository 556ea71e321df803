"""Seconds from process start to the first timed request: imports, the
kernel library (built on a checkout's first run), the weights, the
program's quantization and packing, the warm-up."""


def read(run):
    return run.setup_s
