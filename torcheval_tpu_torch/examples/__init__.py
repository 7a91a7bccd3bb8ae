"""Runnable examples of the port. JAX counterpart: ``examples/``."""
