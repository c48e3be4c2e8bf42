"""fp64 NumPy TRPO oracle (M0) — parity fixture for the JAX engine."""
from . import dynamics, net, trpo

__all__ = ["dynamics", "net", "trpo"]
