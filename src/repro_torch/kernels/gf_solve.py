"""Batched GF(65537) solve — the decode/repair hot-spot.

Erasure decode of a systematic code [I | A] is a two-step computation:

  1. invert the K x K survivor submatrix  S = G[:, kept]   (once per
     erasure pattern), and
  2. apply it to the (K, W) survivor payloads, W up to millions of symbols:
     x = (S^T)^-1 v.

Step 2 is a field matmul on the `gf_matmul` CUDA kernel (its plain
version for a CPU tensor).  Step 1 is an exact Gauss-Jordan
elimination over F_65537 in plain torch int64 on the device: the JAX
package's counterpart (`repro/kernels/gf_solve.py`) is eager jnp with no
Pallas kernel, so it has no hand-written kernel here either.  The numpy
`core.matrices.gauss_inverse` is its host oracle; the inverse of a
nonsingular matrix is unique, so both are bitwise identical.

The elimination runs in int64 throughout (torch's CPU uint32 cannot add,
shift or take `%`), holds [a | I] as one (n, 2n) tensor, takes each pivot's
inverse from a table of all q inverses on the device, and picks and swaps
pivot rows with device-side indices: the host waits on the device once, at
the end, to learn whether some column had no pivot.
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.registry import resolve_device
from ..core.field import FERMAT_Q
from .gf_matmul import gf_matmul

_INV_TABLES: dict[torch.device, torch.Tensor] = {}


def _as_field_u32(x, device=None) -> torch.Tensor:
    """Reduce to [0, q) exactly, then narrow to int32 on `device` (the
    port's device payload dtype; the kernels read it as uint32).

    The mod runs in int64 *before* the narrowing cast — casting first
    would wrap negatives/large values (uint32(-1) % q == 0, but
    -1 mod q == q - 1), silently diverging from the numpy oracle.
    """
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return (x.to(dev).long() % FERMAT_Q).to(torch.int32)
    return torch.as_tensor(np.asarray(x, np.int64) % FERMAT_Q,
                           device=dev).to(torch.int32)


def _inverse_table(device: torch.device) -> torch.Tensor:
    """(q,) int64: t[x] = x^(q-2) mod q, the field inverse (t[0] = 0),
    built once per device by square-and-multiply on numpy int64."""
    table = _INV_TABLES.get(device)
    if table is None:
        base = np.arange(FERMAT_Q, dtype=np.int64)
        acc = np.ones(FERMAT_Q, np.int64)
        e = FERMAT_Q - 2
        while e:
            if e & 1:
                acc = acc * base % FERMAT_Q
            base = base * base % FERMAT_Q
            e >>= 1
        table = _INV_TABLES[device] = torch.as_tensor(acc, device=device)
    return table


def gf_gauss_inverse(a, *, device=None) -> torch.Tensor:
    """Exact inverse of a (n, n) matrix over F_65537 -> (n, n) int64 on
    `device` (None means "cuda").

    Partial pivoting by first nonzero entry (same pivot order as the numpy
    oracle; the result is the unique inverse either way).  Raises
    ``ValueError`` on a singular input — for MDS codes every survivor
    submatrix is nonsingular, but e.g. the DFT transform's [I | A] codeword
    admits singular patterns (see `repro_torch.recover.UndecodableError`).
    """
    dev = resolve_device(device)
    a = _as_field_u32(a, dev).long()
    n = a.shape[0]
    assert a.shape == (n, n), a.shape
    inv_of = _inverse_table(dev)
    aug = torch.cat([a, torch.eye(n, dtype=torch.int64, device=dev)], dim=1)
    pivots = torch.empty(n, dtype=torch.int64, device=dev)
    idx = torch.arange(n, device=dev)
    for col in range(n):
        # first nonzero at or below the diagonal (argmax returns the first
        # maximum); a column with none leaves a zero pivot, reported below.
        # Every index stays a device tensor and no Python scalar is
        # assigned: indexing with a 0-dim tensor (inv_of[t]), a tensor
        # made from a Python int, or `t[i] = 0` (a one-element copy from
        # the host) would each wait on the device.
        piv = col + torch.argmax((aug[col:, col] != 0).to(torch.int8))
        rows = torch.stack([idx[col], piv])
        aug.index_copy_(0, rows, aug.index_select(0, rows.flip(0)))
        pivots[col] = aug[col, col]
        aug[col] = (aug[col] * inv_of.index_select(0, aug[col, col].view(1))
                    % FERMAT_Q)
        f = aug[:, col].clone()  # eliminate every other row
        f[col].zero_()
        aug = (aug - f[:, None] * aug[col][None, :]) % FERMAT_Q
    zero = pivots == 0
    if n and bool(zero.any()):
        col = int(torch.argmax(zero.to(torch.int8)))
        raise ValueError(f"singular matrix over F_{FERMAT_Q} (column {col})")
    return aug[:, n:].contiguous()


def gf_apply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 65537 -> int32: the `gf_matmul` kernel for CUDA operands,
    whatever the shape (the JAX package's `_PALLAS_MIN_DIM` was TPU launch
    tuning and is invisible in the output), its plain version on the CPU."""
    return gf_matmul(a.to(torch.int32).contiguous(),
                     b.to(torch.int32).contiguous())


def gf_solve(a, b, *, device=None) -> torch.Tensor:
    """Solve a @ x = b over F_65537: x = a^-1 b, exact, as an (n, W) int32
    tensor on `device` (None means "cuda").

    a: (n, n), b: (n, W) — the decode use is a = S^T (survivor submatrix,
    transposed) and b the survivor payloads, giving the original data x.
    """
    dev = resolve_device(device)
    return gf_apply(gf_gauss_inverse(a, device=dev), _as_field_u32(b, dev))
