"""K1 CUDA graphs built per traced request: the program's
`qwen3.graph_capture` spans (`ops/megakernel.py::GraphStep`'s first call,
the eager step and the capture) in the traced sub-window over its
requests. None where the program opens no spans."""

from asrbench.spans import per_request


def read(run):
    return per_request(run.trace, "qwen3.graph_capture")
