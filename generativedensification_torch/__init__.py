"""Generative Densification in PyTorch for NVIDIA Hopper.

Port of ``generativedensification_tpu`` (JAX/Flax + Pallas), which stays in
the repository as the reference.  Plain tensor code is PyTorch; the TPU's
Pallas kernels become hand-written CUDA kernels under ``csrc/``, built at
first use.  This package imports neither JAX nor the JAX package.
"""
