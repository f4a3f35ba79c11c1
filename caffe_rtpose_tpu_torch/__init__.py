"""caffe_rtpose_tpu_torch — the realtime pose estimator in PyTorch for NVIDIA
Hopper GPUs.

A port of ``caffe_rtpose_tpu`` (the JAX/TPU package, kept beside it as the
reference).  Module names mirror the JAX package's so each counterpart is
easy to find.  This package imports ``torch`` and never ``jax``, and never
imports anything under ``caffe_rtpose_tpu`` (whose ``__init__`` loads jax):
the jax-free host code it needs is copied.  CUDA kernels live in ``csrc/``
and are built with ``nvcc`` at first use (see ``_build.py``).
"""

__version__ = "0.1.0"
