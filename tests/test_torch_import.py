"""The port imports no JAX and nothing of the JAX package, builds its
kernels from its own CUDA sources, and never hands a non-CPU tensor to a
plain twin."""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import qwen3_asr_tpu_torch

PKG = Path(qwen3_asr_tpu_torch.__file__).parent


def _modules():
    return [m.name for m in pkgutil.walk_packages(qwen3_asr_tpu_torch.__path__,
                                                  "qwen3_asr_tpu_torch.")]


def test_no_jax_in_import_chain():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, sorted(k for k in sys.modules "
            "if k.startswith('jax'))\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def _chip_smoke_imports() -> list[str]:
    """Every module chip_smoke.py imports, at top level or in a function."""
    tree = ast.parse((PKG.parent / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return sorted(names)


def test_no_jax_package_in_import_chain():
    """Every module of the port and every import of chip_smoke.py, in a fresh
    process: no module named qwen3_asr_tpu or qwen3_asr_tpu.* is loaded."""
    mods = _modules() + _chip_smoke_imports() + ["chip_smoke"]
    assert "qwen3_asr_tpu_torch.pipeline.asr" in mods and "torch" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'qwen3_asr_tpu' "
            "or k.startswith('qwen3_asr_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(PKG.parent), timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_every_module_imports():
    assert len(_modules()) >= 15
    for name in _modules():
        importlib.import_module(name)


@pytest.mark.parametrize("src,replaces", [
    ("flash_attention.cu", "pallas_attention.py::_flash_kernel"),
    ("megakernel.cu", "megakernel.py::_mega_kernel"),
    ("megakernel_batch.cu", "megakernel_batch.py::_mega_batch_kernel"),
    ("q8_matmul.cu", "q8_matmul.py::_q8_kernel"),
    ("q8_matmul.cu", "q8_matmul.py::_q8_norm_kernel"),
    ("q8_matmul.cu", "q8_matmul.py::_q8_mlp_kernel"),
    ("decode_attention.cu", "decode_attention.py::_decode_attn_kernel"),
])
def test_kernel_sources_are_hand_written_cuda(src, replaces):
    text = (PKG / "csrc" / src).read_text()
    assert replaces in text
    assert "torch/extension.h" not in text
    assert "cublas" not in text.lower() and "cudnn" not in text.lower()
    assert "__global__" in text


def test_no_library_attention_or_compile_in_port():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path
        assert "import jax" not in text, path


def test_build_hash_tracks_sources():
    from qwen3_asr_tpu_torch.ops import build

    h = build.source_hash()
    assert h == build.source_hash() and len(h) == 16
    names = {p.name for p in build._sources()}
    assert {"flash_attention.cu", "megakernel.cu", "megakernel.cuh",
            "megakernel_batch.cu", "probe.cu", "q8_matmul.cu",
            "decode_attention.cu"} <= names


def test_non_cpu_tensor_never_reaches_a_twin():
    """A tensor off the CPU launches the kernel or raises: the meta device
    has no kernel, so the wrappers must raise rather than run the twin."""
    from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
    from qwen3_asr_tpu_torch.ops.megakernel_batch import mega_decode_step_batch
    from qwen3_asr_tpu_torch.ops.support import has_cuda_kernels, require_cuda

    q = torch.empty(1, 8, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attention_batch(q, q[:, :, :1], q[:, :, :1], [8], causal=True,
                              scale=0.125)
    k = torch.empty(2, 1, 8, 16, device="meta", dtype=torch.int8)
    with pytest.raises(RuntimeError, match="CUDA"):
        mega_decode_step_batch({}, None, torch.zeros(2, dtype=torch.int32), [1, 2],
                               k, k, k.float(), k.float())
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention

    x = torch.empty(1, 64, device="meta", dtype=torch.bfloat16)
    w = {"q8:q": torch.empty(64, 128, device="meta", dtype=torch.int8),
         "q8:s": torch.empty(2, 128, device="meta")}
    with pytest.raises(RuntimeError, match="CUDA"):
        q8.q8_matmul(x, w["q8:q"], w["q8:s"])
    with pytest.raises(RuntimeError, match="CUDA"):
        q8.q8_norm_matmul(x, w, x[0], 1e-6)
    with pytest.raises(RuntimeError, match="CUDA"):
        q8.q8_mlp(x, w, w, x[0], 1e-6, 64)
    c = torch.empty(8, 2, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_attention(x[:, :128], c, c, c[0, 0], c[0, 0], 3, 3, n_heads=4, n_kv=2,
                         head_dim=16, eps=1e-6, theta=1e6, scale=0.25)
    with pytest.raises(RuntimeError):
        require_cuda(torch.zeros(1), "x")
    if not torch.cuda.is_available():
        assert not has_cuda_kernels()
