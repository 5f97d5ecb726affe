"""PyTorch / CUDA port of ``self_supervise_sfm_tpu`` for NVIDIA Hopper.

Module names mirror the JAX package. This package imports ``torch``, numpy
and the standard library, and ``h5py``, PIL, matplotlib and
``tensorboardX`` only inside the functions that read scenes, draw plots or
write event files: never ``jax`` and nothing of the JAX package.
Hand-written CUDA kernels live in ``csrc/`` and are built on first use
(``_kernels.py``).
"""
