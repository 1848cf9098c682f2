"""g2vlm_tpu_torch — the PyTorch/CUDA port of g2vlm_tpu for NVIDIA Hopper.

The JAX package `g2vlm_tpu` stays the reference; every module here mirrors
its counterpart's name and is held against it by the tests/test_torch_*.py
parity tests. This package imports torch, never jax, and nothing of
`g2vlm_tpu`: it keeps its own copies of the config and image modules.
Attention, forward and backward, runs through hand-written CUDA kernels
(`ops/flash_attention.py`, `csrc/*.cu`) on CUDA tensors and through their
plain PyTorch versions on CPU tensors.
"""

__version__ = "0.1.0"
