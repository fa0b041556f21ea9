"""Plain PyTorch versions of the two CUDA kernels and of gf_matmul's batched
entry (exact, int64, any device).

The CPU runs these in place of the kernels; on the card they serve only to
check the kernels (`chip_smoke.py`), never the main path.  PyTorch has no
integer matmul on CUDA, so `gf_matmul_plain` is a chunked
broadcast-multiply-sum rather than one `@`.
"""
from __future__ import annotations

import torch

from ..core.field import FERMAT_Q, fermat_add, fermat_mul, fermat_sub

# elements of the (M, k, N) int64 product block formed per chunk (128 MiB)
_CHUNK_ELEMS = 1 << 24


def gf_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 65537, exact: a (M, K), b (K, N) integer tensors with
    values in [0, q) -> (M, N) int64.

    Each product is at most 2^32, so an int64 sum of a chunk of fewer than
    2^31 of them is exact; the running total is reduced after every chunk.
    """
    M, K = a.shape
    K2, N = b.shape
    assert K == K2, (a.shape, b.shape)
    a, b = a.long(), b.long()
    out = torch.zeros((M, N), dtype=torch.int64, device=a.device)
    step = max(1, _CHUNK_ELEMS // max(1, M * N))
    for s in range(0, K, step):
        prods = a[:, s:s + step, None] * b[None, s:s + step, :]  # (M, c, N)
        out = (out + prods.sum(dim=1)) % FERMAT_Q
    return out


def gf_matmul_batched_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a[z] @ b[z]) mod 65537 for every z, exact: a (B, M, K), b (B, K, N)
    integer tensors with values in [0, q) -> (B, M, N) int64, by the
    chunked int64 sums of `gf_matmul_plain`."""
    B, M, K = a.shape
    B2, K2, N = b.shape
    assert (B, K) == (B2, K2), (a.shape, b.shape)
    a, b = a.long(), b.long()
    out = torch.zeros((B, M, N), dtype=torch.int64, device=a.device)
    step = max(1, _CHUNK_ELEMS // max(1, B * M * N))
    for s in range(0, K, step):
        prods = a[:, :, s:s + step, None] * b[:, None, s:s + step, :]
        out = (out + prods.sum(dim=2)) % FERMAT_Q
    return out


def ntt_plain(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """The batched radix-2 NTT along axis 0 of x (Z, C) -> (Z, C) int64: the
    stage loop of the JAX package's `_ntt_stages` (DIF forward with
    bit-reversed output; the inverse runs the stages backwards with inverse
    twiddles), then the Z^-1 scale of its `ntt` for the inverse."""
    from .ntt import ntt_twiddles

    Z = x.shape[0]
    H = Z.bit_length() - 1
    assert Z >= 1 and 1 << H == Z, "Z must be a power of two"
    tw = torch.as_tensor(ntt_twiddles(Z, inverse=inverse).astype("int64"),
                         device=x.device)
    x = x.long()
    for h in (range(H - 1, -1, -1) if inverse else range(H)):
        half = Z >> (h + 1)
        groups = Z // (2 * half)
        xr = x.reshape(groups, 2 * half, -1)
        u, v = xr[:, :half], xr[:, half:]
        twr = tw[h].reshape(groups, half)[:, :, None]
        if inverse:
            m = fermat_mul(v, twr)
            s, d = fermat_add(u, m), fermat_sub(u, m)
        else:
            s, d = fermat_add(u, v), fermat_mul(fermat_sub(u, v), twr)
        x = torch.cat([s, d], dim=1).reshape(Z, -1)
    if inverse:
        x = x * pow(Z, FERMAT_Q - 2, FERMAT_Q) % FERMAT_Q
    return x
