"""Pure-Python GGUF reader (host side).

The port's own copy of the reader half of qwen3_asr_tpu/runtime/gguf.py:
parses GGUF v2/v3 metadata, exposes tensor data as zero-copy numpy views
over an mmap, and decodes Q8_0 blocks either to float (`get`) or to raw
(int8, f16 scale) pairs (`get_q8_0`) for the Q8_0 kernels.

Layout notes:
- tensor dims are stored fastest-varying first (ne[0] fastest). A GGUF 2-D
  tensor with ne=[in, out] therefore maps to a C-order numpy array of shape
  (out, in); weights need a transpose to the [in, out] layout of y = x @ W.
- Q8_0: blocks of 32 values as (f16 scale, 32 x int8), 34 bytes per block.
"""

from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF"

# ggml_type ids (subset)
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q8_0 = 8

_Q8_BLOCK = 32
_Q8_BLOCK_BYTES = 2 + _Q8_BLOCK  # f16 scale + 32 int8

# GGUF metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)

_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return vals[0] if len(vals) == 1 else vals

    def read_str(self) -> str:
        n = self.read("<Q")
        s = bytes(self.buf[self.pos : self.pos + n]).decode("utf-8")
        self.pos += n
        return s

    def read_value(self, vtype: int):
        if vtype == _BOOL:
            return bool(self.read("<B"))
        if vtype == _STR:
            return self.read_str()
        if vtype == _ARR:
            etype = self.read("<I")
            n = self.read("<Q")
            return [self.read_value(etype) for _ in range(n)]
        return self.read(_SCALAR_FMT[vtype])


@dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # GGUF order: ne[0] fastest
    ggml_type: int
    offset: int             # relative to data section

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        if self.ggml_type == GGML_TYPE_F32:
            return self.n_elements * 4
        if self.ggml_type == GGML_TYPE_F16:
            return self.n_elements * 2
        if self.ggml_type == GGML_TYPE_Q8_0:
            if self.n_elements % _Q8_BLOCK:
                raise ValueError(f"{self.name}: Q8_0 needs a multiple of 32 values")
            return self.n_elements // _Q8_BLOCK * _Q8_BLOCK_BYTES
        raise ValueError(f"unsupported ggml type {self.ggml_type}")


def dequantize_q8_0(raw: np.ndarray, n_elements: int) -> np.ndarray:
    """Decode Q8_0 blocks (uint8 raw bytes) -> float32 [n_elements]."""
    blocks = raw.reshape(-1, _Q8_BLOCK_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [n,1]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (qs * scales).reshape(-1)[:n_elements]


def q8_0_views(raw: np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Split Q8_0 raw bytes into (int8 values [n], f16 scales [n/32])."""
    blocks = raw.reshape(-1, _Q8_BLOCK_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).reshape(-1)
    qs = blocks[:, 2:].view(np.int8).reshape(-1)[:n_elements]
    return qs, scales


class GGUFFile:
    """mmap-backed GGUF file: `.metadata` dict, `.tensors` dict of TensorInfo,
    `get(name)` -> numpy array in numpy (C-order) shape = reversed(ne)."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError):
            self._file.close()
            raise
        r = _Reader(self._mm)

        magic = r.read("<I")
        if magic != GGUF_MAGIC:
            self.close()
            raise ValueError(f"not a GGUF file: {path}")
        self.version = r.read("<I")
        if self.version < 2:
            self.close()
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = r.read("<q")
        n_kv = r.read("<q")

        self.metadata: dict = {}
        for _ in range(n_kv):
            key = r.read_str()
            vtype = r.read("<I")
            self.metadata[key] = r.read_value(vtype)

        self.tensors: dict[str, TensorInfo] = {}
        for _ in range(n_tensors):
            name = r.read_str()
            n_dims = r.read("<I")
            shape = tuple(r.read("<Q") for _ in range(n_dims))
            ggml_type = r.read("<I")
            offset = r.read("<Q")
            self.tensors[name] = TensorInfo(name, shape, ggml_type, offset)

        alignment = self.metadata.get("general.alignment", 32)
        self.data_offset = (r.pos + alignment - 1) // alignment * alignment

    def close(self):
        """Best-effort close: numpy views handed out by get() keep the mmap
        alive; then the mapping is released when they are collected."""
        try:
            self._mm.close()
        except BufferError:
            pass
        self._file.close()

    def raw_bytes(self, name: str) -> np.ndarray:
        ti = self.tensors[name]
        start = self.data_offset + ti.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=ti.nbytes, offset=start)

    def get(self, name: str) -> np.ndarray:
        """Tensor as numpy array with shape reversed(ne) (C order): F32/F16
        as zero-copy views into the mmap, Q8_0 decoded to f32."""
        ti = self.tensors[name]
        raw = self.raw_bytes(name)
        np_shape = tuple(reversed(ti.shape))
        if ti.ggml_type == GGML_TYPE_F32:
            return raw.view(np.float32).reshape(np_shape)
        if ti.ggml_type == GGML_TYPE_F16:
            return raw.view(np.float16).reshape(np_shape)
        if ti.ggml_type == GGML_TYPE_Q8_0:
            return dequantize_q8_0(raw, ti.n_elements).reshape(np_shape)
        raise ValueError(f"unsupported tensor type {ti.ggml_type} for {name}")

    def get_q8_0(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """A Q8_0 tensor's raw (int8 values [n], f16 scales [n/32])."""
        ti = self.tensors[name]
        if ti.ggml_type != GGML_TYPE_Q8_0:
            raise ValueError(f"{name} is not Q8_0 (ggml type {ti.ggml_type})")
        return q8_0_views(self.raw_bytes(name), ti.n_elements)
