"""Serving steps of the port (`train.serve`); the training half of the
JAX package's `train/` is not ported yet."""
from . import serve

__all__ = ["serve"]
