"""The field-matmul entry points of the encode and decode paths.

On a CUDA tensor every call launches the `gf_matmul` kernel, whatever the
shape: the JAX package's `_PALLAS_MIN_DIM = 128` dispatch (plain jnp below
128 x 128) was TPU launch-overhead tuning, and the choice is
bitwise-invisible.  On a CPU tensor the plain version runs.
"""
from __future__ import annotations

import torch

from .gf_matmul import gf_matmul


def encode_blocks(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """y = x^T-style field encode: (S, W) data against (S, T) coefficients.

    Returns (T, W) = coeffs.T @ x over F_65537; int32 in and out.
    """
    return gf_matmul(coeffs.T.contiguous(), x.contiguous())


def decode_blocks(v: torch.Tensor, dmat: torch.Tensor) -> torch.Tensor:
    """Apply a precomputed decode matrix to survivor payloads.

    v: (K, W) survivor symbols, dmat: (K, E) — returns (E, W) = dmat.T @ v
    over F_65537.  The exact dual of `encode_blocks`: decode of an erasure
    pattern is an encode with the repair matrix D = S^-1 G[:, E] (S the
    survivor submatrix), so the same kernel serves both hot paths.
    """
    return encode_blocks(v, dmat)
