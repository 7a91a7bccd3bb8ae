"""Counting, compaction, curve and top-k functions, with the CUDA kernels
behind them. JAX counterpart: ``torcheval_tpu/ops/``."""
