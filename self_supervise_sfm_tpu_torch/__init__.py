"""PyTorch / CUDA port of ``self_supervise_sfm_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package. This package imports ``torch``, numpy
and the standard library only: never ``jax`` and nothing of the JAX
package. Hand-written CUDA kernels live in ``csrc/`` and are built on first
use (``_kernels.py``).
"""
