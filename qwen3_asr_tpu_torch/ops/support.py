"""Capability gate and launch checks for the port's CUDA kernels.

Counterpart of qwen3_asr_tpu/ops/support.py::has_pallas_tpu. The rule every
kernel wrapper follows: a tensor on the CPU takes the kernel's plain PyTorch
version; a tensor on a CUDA device launches the kernel or raises. There is
no fallback from a failed build or launch to the plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch


def require_cuda(t: torch.Tensor, what: str = "tensor") -> None:
    """Raise unless `t` lives on a CUDA device."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{what} must be on a CUDA device, got {t.device}")


def resolve_device(device) -> torch.device:
    """A torch.device for a user's device argument. Asking for CUDA on a
    machine without a CUDA device raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but no CUDA device "
                           "is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple | None = None, device: torch.device | None = None
          ) -> None:
    """Validate a kernel argument: dtype, shape, contiguity, device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convolutions in full f32 inside the block: TF32
    explicitly off for both cuBLAS and cuDNN (cuDNN convs default to TF32).
    The previous settings are restored on exit."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        from qwen3_asr_tpu_torch.ops.build import kernel

        msg = kernel("qw_error_string", [ctypes.c_int], ctypes.c_char_p)(rc)
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({(msg or b'?').decode()})")


def has_sm90() -> bool:
    """True iff a CUDA device of compute capability 9.0 is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(0) == (9, 0))


@functools.cache
def has_cuda_kernels() -> bool:
    """True iff a CUDA device of compute capability 9.0 is present and the
    kernel library's probe kernel runs right on it. On such a device a
    library that does not build or load raises. The probe's launches are
    counted in `has_cuda_kernels.launches`."""
    if not has_sm90():
        return False
    from qwen3_asr_tpu_torch.ops.build import kernel

    fn = kernel("qw_probe", [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), stream_ptr(dev))
    has_cuda_kernels.launches += 1
    if rc != 0:
        return False
    return bool(torch.equal(y, 2 * x))


has_cuda_kernels.launches = 0


def kernels_a_call(fn) -> int:
    """Kernel launches one fn() makes: the kernel nodes of a CUDA graph
    that captures one call (made after one call outside it), read with
    cuGraphGetNodes. A graph records every launch on the stream, whichever
    library makes it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernel_nodes = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernel_nodes += kind.value == 0   # CU_GRAPH_NODE_TYPE_KERNEL
    return kernel_nodes
