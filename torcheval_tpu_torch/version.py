"""Package version. JAX counterpart: ``torcheval_tpu/version.py``."""

__version__ = "0.1.0"
