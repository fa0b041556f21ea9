"""The plain reference of the coding configurations: systematic Reed-Solomon
over F_65537, in NumPy and plain PyTorch.

It imports nothing of the program under test.  The generator is derived here
from the construction the paper gives for a systematic GRS code whose
evaluation points suit the decentralized schedule (Sec. VI): K + R distinct
points g^(b M + i) * zeta^rev(j) on cosets of the Z-th roots of unity, with
u = v = 1, so the non-systematic block is the Cauchy-like matrix

    A[k, r] = c_k d_r / (beta_r - alpha_k),
    c_k = 1 / prod_{j != k} (alpha_k - alpha_j),
    d_r = prod_k (beta_r - alpha_k)                      (eq. 24).

The codeword of data x (K, W) is [x | A^T x] (N = K + R rows).  A degraded
read recovers x from any K surviving rows by the inverse of the generator's
columns at those rows; the inverse is Gauss-Jordan over F_q here.

Products go through float64 matmuls on the chosen device: every operand is
below q < 2^17 and every row sum has at most a few hundred terms, so each
partial sum stays below 2^53 and float64 is exact.  `dtype=torch.float32`
(TF32 off) is the lower-precision control, which is not exact.

This file is frozen with the benchmark: a later change to it changes what
`correct` means.
"""
from __future__ import annotations

import numpy as np
import torch

Q = 65537          # the Fermat prime 2^16 + 1
GENERATOR = 3      # the smallest generator of F_65537's multiplicative group
COLUMN_BLOCK = 1 << 16  # columns per device matmul block


def _inv(a) -> np.ndarray:
    """Elementwise inverse in F_q (a != 0), by Fermat's little theorem."""
    a = np.asarray(a, np.int64) % Q
    out = np.ones_like(a)
    base, e = a.copy(), Q - 2
    while e:
        if e & 1:
            out = out * base % Q
        base = base * base % Q
        e >>= 1
    return out


def _digit_reverse(j: int, bits: int) -> int:
    return int(format(j, f"0{bits}b")[::-1], 2) if bits else 0


def _point_set(M: int, H: int, offset: int) -> np.ndarray:
    """M * 2^H points g^(offset + i) * zeta^rev(j), index i * 2^H + j."""
    Z = 1 << H
    zeta = pow(GENERATOR, (Q - 1) // Z, Q)
    return np.array([pow(GENERATOR, offset + i, Q)
                     * pow(zeta, _digit_reverse(j, H), Q) % Q
                     for i in range(M) for j in range(Z)], np.int64)


def rs_points(K: int, R: int) -> tuple[np.ndarray, np.ndarray]:
    """(alphas (K,), betas (R,)): the data and parity evaluation points.

    The smaller side s = min(K, R) is split as M * 2^H with 2^H the largest
    power of two dividing s; max(K, R) / s + 1 sets of s points follow one
    another on consecutive cosets.  K >= R: the first K / R sets are the
    alphas, the last the betas; K < R the other way round."""
    big, small = max(K, R), min(K, R)
    if big % small:
        raise ValueError(f"the construction needs K | R or R | K, got "
                         f"K={K}, R={R}")
    H = 0
    while small % (2 << H) == 0 and (Q - 1) % (2 << H) == 0:
        H += 1
    M = small >> H
    sets = [_point_set(M, H, b * M) for b in range(big // small + 1)]
    if K >= R:
        return np.concatenate(sets[:-1]), sets[-1]
    return sets[-1], np.concatenate(sets[:-1])


def rs_generator(K: int, R: int) -> np.ndarray:
    """The (K, R) non-systematic block A of G = [I | A] (int64, < q)."""
    alphas, betas = rs_points(K, R)
    diff = (alphas[:, None] - alphas[None, :]) % Q
    np.fill_diagonal(diff, 1)
    c = _inv(_prod_rows(diff))
    d = _prod_rows(((betas[:, None] - alphas[None, :]) % Q))
    denom = _inv((betas[None, :] - alphas[:, None]) % Q)
    return c[:, None] * d[None, :] % Q * denom % Q


def _prod_rows(m: np.ndarray) -> np.ndarray:
    out = np.ones(m.shape[0], np.int64)
    for col in m.T:
        out = out * col % Q
    return out


def generator_matrix(K: int, R: int) -> np.ndarray:
    """G = [I | A], (K, N)."""
    return np.concatenate([np.eye(K, dtype=np.int64), rs_generator(K, R)], 1)


def inverse_mod(m: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over F_q by Gauss-Jordan (raises when it is
    singular)."""
    n = m.shape[0]
    a = np.concatenate([np.asarray(m, np.int64) % Q,
                        np.eye(n, dtype=np.int64)], 1)
    for c in range(n):
        nz = np.nonzero(a[c:, c])[0]
        if nz.size == 0:
            raise ValueError("singular matrix over F_q")
        p = c + int(nz[0])
        if p != c:
            a[[c, p]] = a[[p, c]]
        a[c] = a[c] * _inv(a[c, c]) % Q
        f = a[:, c].copy()
        f[c] = 0
        a = (a - f[:, None] * a[c][None, :]) % Q
    return a[:, n:]


def _matmul_mod(mat: np.ndarray, x, device, dtype) -> np.ndarray:
    """(mat @ x) mod q, int64 (rows, W), in column blocks on `device`.

    `x` is a NumPy integer array (K, W); every entry of both below q."""
    if dtype == torch.float32:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        m = torch.as_tensor(np.asarray(mat) % Q, dtype=dtype, device=device)
        out = np.empty((mat.shape[0], x.shape[1]), np.int64)
        for c0 in range(0, x.shape[1], COLUMN_BLOCK):
            xb = torch.as_tensor(np.ascontiguousarray(x[:, c0:c0 + COLUMN_BLOCK]),
                                 device=device).to(dtype)
            y = torch.remainder(m @ xb, Q)
            out[:, c0:c0 + xb.shape[1]] = y.to(torch.int64).cpu().numpy()
        return out
    finally:
        if dtype == torch.float32:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def encode(x, A: np.ndarray, device="cpu", dtype=torch.float64) -> np.ndarray:
    """Parity A^T x (R, W) of data x (K, W)."""
    return _matmul_mod(A.T, x, device, dtype)


def codeword(x, A: np.ndarray, device="cpu", dtype=torch.float64) -> np.ndarray:
    """The systematic codeword [x | A^T x], (N, W) int64."""
    return np.concatenate([np.asarray(x, np.int64) % Q,
                           encode(x, A, device, dtype)], 0)


def survivors(failed, K: int, N: int) -> list[int]:
    """The K lowest surviving positions (any K survivors determine x)."""
    bad = set(int(e) for e in failed)
    kept = [i for i in range(N) if i not in bad][:K]
    if len(kept) < K:
        raise ValueError(f"{len(bad)} failures leave fewer than K={K} rows")
    return kept


def read_matrix(G: np.ndarray, kept) -> np.ndarray:
    """(K, K) D with x = D @ cw[kept]: the inverse of G[:, kept]^T."""
    return inverse_mod(G[:, list(kept)].T)


def read(cw, G: np.ndarray, failed, device="cpu",
         dtype=torch.float64) -> np.ndarray:
    """The data x (K, W) from the survivors of codeword rows `cw` (N, W);
    rows at `failed` are never read."""
    K, N = G.shape
    kept = survivors(failed, K, N)
    return _matmul_mod(read_matrix(G, kept), np.asarray(cw)[kept], device,
                       dtype)


def rebuild(cw, G: np.ndarray, failed, device="cpu",
            dtype=torch.float64) -> np.ndarray:
    """The whole codeword (N, W) from the survivors of `cw`."""
    K, N = G.shape
    x = read(cw, G, failed, device, dtype)
    return codeword(x, G[:, K:], device, dtype)
