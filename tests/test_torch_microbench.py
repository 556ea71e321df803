"""The weight-stream microbenchmarks (qwen3_asr_tpu_torch/microbench_stream.py,
K9-K11) on the CPU: their plain twins against numpy, against the TPU's own
stream kernel, and the nibble order against K11's finding. The CUDA kernels
vs these twins: tests/test_torch_cuda.py.

- The twins (`read`, `int8_m1` / `int8_m8`, `bf16_m8`, `int4_m1`,
  `unpack_nibbles`) against a numpy computation of the same function at a
  small stream: exact for the integer modes (int64 sums, wrapped to int32 as
  the kernels' int32 sums wrap), bf16_m8 at rtol 1e-6 (one f32 rounding of an
  exact float64 sum against numpy's).
- `pack_nibbles` / `unpack_nibbles` against `nibbles` of
  scripts/probe_int4b.py (K11's numpy statement of the TPU's order: row 2r
  the low nibble, row 2r + 1 the high one, both sign-extended).
- K9's `_stream_kernel` (scripts/microbench_stream.py) in Pallas interpret
  mode, through a pallas_call built here as the script builds it but with
  interpret=True: with every chunk's scale row equal to one power of two,
  its per-chunk f32 sums are exact, so its int8_m1 / int8_m8 / bf16_m8
  outputs equal the twins' f32(sum) * s exactly.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch import microbench_stream as mb
from qwen3_asr_tpu_torch.ops.megakernel import pack_nibbles, unpack_nibbles

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
N_CHUNKS, C = 3, 128


def _script(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data():
    return mb.make_data(N_CHUNKS, C, "cpu", seed=5)


def test_read_twin_matches_numpy(data):
    w = data["w"].numpy()
    assert int(mb.stream_read(data["w"])[0]) == int(w.astype(np.int64).sum())
    assert int(mb.stream_read_ring(data["w"])[0]) == int(w.astype(np.int64).sum())
    assert mb.stream_read.launches == 0 and mb.stream_read_ring.launches == 0  # twins


@pytest.mark.parametrize("mode", list(mb.GEMV_MODES))
def test_gemv_twin_matches_numpy(data, mode):
    M = 1 if mode == "int8_m1" else 8
    x, w, s = data["x8"][:M].contiguous(), data["w"], data["s"]
    tot = np.einsum("mr,irc->mc", x.numpy().astype(np.int64), w.numpy().astype(np.int64))
    got = mb.stream_gemv(mode, x, w, s).numpy()
    if mode == "bf16_m8":
        np.testing.assert_allclose(got, tot.astype(np.float32) * s.numpy(), rtol=1e-6)
    else:
        wrapped = ((tot + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
        np.testing.assert_array_equal(got, wrapped.astype(np.float32) * s.numpy())


def test_int32_sums_wrap_like_the_kernel():
    """Sums past 2^31 wrap mod 2^32 in the twin as the kernel's int32 atomics
    wrap: 70 chunks of 1,024 rows of 127 x 127 sum past 2^31 in every
    column."""
    x = torch.full((1, mb.IN), 127, dtype=torch.int8)
    w = torch.full((70, mb.IN, 64), 127, dtype=torch.int8)
    got = mb.gemv_ref("int8_m1", x, w, torch.ones(64))
    want = np.int64(70 * mb.IN * 127 * 127)
    assert float(got[0, 0]) == float(np.int32(((want + 2 ** 31) % 2 ** 32) - 2 ** 31))


def test_int4_twin_matches_numpy(data):
    x, w4, s4 = data["x8"][0].contiguous(), data["w4"], data["s4"]
    got = mb.stream_gemv_i4(x, w4, s4).numpy()
    w8 = unpack_nibbles(w4).numpy().astype(np.int64)          # [n, 1024, C]
    xi = x.numpy().astype(np.int64)
    for i in range(N_CHUNKS):
        d = [(xi[g * 512:(g + 1) * 512] @ w8[i, g * 512:(g + 1) * 512]).astype(np.float32)
             for g in range(2)]
        want = d[0] * s4[i, 0].numpy() + d[1] * s4[i, 1].numpy()
        np.testing.assert_array_equal(got[i], want)


def test_nibble_order_matches_k11():
    """K11's `nibbles` (probe_int4b.py:43): byte -> (lo, hi) signed nibbles.
    The port's pack puts row 2r in lo and row 2r + 1 in hi."""
    nibbles = _script("probe_int4b").nibbles
    rng = np.random.default_rng(2)
    b = rng.integers(-128, 128, (64, 96), dtype=np.int8)
    lo, hi = nibbles(b)
    got = mb.unpack_probe(torch.from_numpy(b.view(np.uint8))).numpy()
    np.testing.assert_array_equal(got[0::2], lo)
    np.testing.assert_array_equal(got[1::2], hi)
    q = np.empty((128, 96), np.int8)
    q[0::2], q[1::2] = lo, hi
    np.testing.assert_array_equal(pack_nibbles(torch.from_numpy(q)).numpy(), b.view(np.uint8))


@pytest.mark.parametrize("mode", list(mb.GEMV_MODES))
def test_twin_matches_k9_interpret(data, mode):
    """K9's `_stream_kernel` run by Pallas in interpret mode on the same
    chunks and x rows, every chunk's scale row 0.25."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    k9 = _script("microbench_stream")
    M = 1 if mode == "int8_m1" else 8
    x = data["x8"][:M].contiguous()
    w = data["w"]
    kernel = functools.partial(k9._stream_kernel, n_chunks=N_CHUNKS,
                               mode="bf16_m8" if mode == "bf16_m8" else f"int8_m{M}")
    call = pl.pallas_call(
        kernel, grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((M, C), jnp.float32),
        scratch_shapes=[pltpu.VMEM((k9.NBUF, k9.IN, C), jnp.int8),
                        pltpu.VMEM((M, C), jnp.float32),
                        pltpu.SemaphoreType.DMA((k9.NBUF,))],
        interpret=True)
    want = np.asarray(call(jnp.asarray(x.numpy()), jnp.full((N_CHUNKS, C), 0.25, jnp.float32),
                           jnp.asarray(w.numpy())))
    got = mb.stream_gemv(mode, x, w, torch.full((C,), 0.25)).numpy()
    np.testing.assert_array_equal(got, want)
