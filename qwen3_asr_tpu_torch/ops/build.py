"""Build the port's CUDA kernels (`csrc/*.cu`) into one shared library.

The sources are compiled at first use with `nvcc` for `sm_90a` (plain C
entry points, no PyTorch headers), one `nvcc` process per source, all
started together, and linked into `build/torch_kernels/` at the root of the
checkout under a name keyed by a hash of the sources and flags, then loaded
with `ctypes`. Nothing here runs at import time: the CPU tests import
every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Entry points run once right after the library loads (kernel attributes
# such as a dynamic shared-memory limit above 48 KB), so that no first call
# sets them lazily, inside a CUDA graph's capture for one.
INIT_ENTRIES = ("qw_flash_init", "qw_mega_batch_init", "qw_q8_init",
                "qw_decode_attention_init", "qw_moe_init")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library. Raises on any build
    or load failure; the caller gets no fallback."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / f"libqwen3_kernels_{source_hash()}.so"
        if not so.exists():
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            tag = f"{so.stem}.tmp{os.getpid()}"
            cus = sorted(CSRC.glob("*.cu"))
            objs = [BUILD_DIR / f"{tag}.{cu.stem}.o" for cu in cus]
            cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                     str(cu)] for cu, o in zip(cus, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outs = [p.communicate()[0] for p in procs]
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = None
            if all(p.returncode == 0 for p in procs):
                res = subprocess.run(link, capture_output=True, text=True)
                outs.append(res.stdout + res.stderr)
            (BUILD_DIR / "nvcc.log").write_text("\n".join(
                " ".join(c) + "\n" + o for c, o in zip(cmds + [link], outs)))
            for o in objs:
                o.unlink(missing_ok=True)
            if res is None or res.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + "\n".join(outs)[-4000:])
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        for name in INIT_ENTRIES:
            rc = getattr(lib, name)()
            if rc != 0:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        _lib = lib
        return _lib


def kernel(name: str, argtypes: list, restype=ctypes.c_int):
    """A C entry point of the library with its ctypes signature set."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn
