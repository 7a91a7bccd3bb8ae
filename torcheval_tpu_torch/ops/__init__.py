"""Counting, compaction and curve functions, with the CUDA kernels behind
them. JAX counterpart: ``torcheval_tpu/ops/``."""
