"""qwen3_asr_tpu_torch — the PyTorch / CUDA port of qwen3_asr_tpu.

The JAX package `qwen3_asr_tpu` is the reference. This package imports
`torch` and never `jax`, and nothing of the JAX package: it keeps its own
copies of the host-only modules it needs (`config`, `text/`,
`runtime/gguf.py`). Every Pallas kernel on the ported paths is a CUDA C++
kernel under `csrc/`, built for sm_90a at first use, with a plain PyTorch
twin beside it.
"""

__version__ = "0.1.0"
