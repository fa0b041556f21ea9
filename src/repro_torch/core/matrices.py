"""Coding matrices used throughout the paper.

Everything is exact numpy int64 over a prime field (`core.field.Field`).
These constructions follow Sec. V/VI of the paper:

* Vandermonde `V[i, j] = alpha_j ** i`
* DFT matrix `D_K` (eq. 8) and its column permutation `D_K @ P` with
  `P[k, rev(k)] = 1` (digit reversal base P)
* generalized Reed-Solomon generator (eq. 22), its systematic form
  `A = (V_alpha P)^-1 V_beta Q` (eq. 23) and the equivalent Cauchy-like
  closed form (eq. 24)
* Lagrange matrices `L = V_alpha^-1 V_beta` (Remark 9)
* structured evaluation-point sets `omega_{i,j} = g^{phi(i)} * zeta^{rev(j)}`
  (eq. 15) that make draw-and-loose (and hence RS/Lagrange specific
  algorithms) applicable.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .field import Field


def digits(k: int, base: int, width: int) -> list[int]:
    """Base-`base` digits of k, least significant first, padded to `width`."""
    out = []
    for _ in range(width):
        out.append(k % base)
        k //= base
    return out


def digit_reverse(k: int, base: int, width: int) -> int:
    """Reverse the base-`base` digit string of k (paper eq. 7)."""
    ds = digits(k, base, width)
    out = 0
    for d in ds:  # least-significant digit becomes most-significant
        out = out * base + d
    return out


def vandermonde(field: Field, points, nrows: int | None = None) -> np.ndarray:
    """V[i, j] = points[j]^i, shape (nrows, len(points))."""
    points = field.arr(points)
    n = nrows if nrows is not None else points.size
    v = np.ones((n, points.size), np.int64)
    for i in range(1, n):
        v[i] = field.mul(v[i - 1], points)
    return v


def gauss_inverse(field: Field, a: np.ndarray) -> np.ndarray:
    """Exact matrix inverse over F_q via Gauss-Jordan elimination."""
    a = field.arr(a).copy()
    n = a.shape[0]
    assert a.shape == (n, n)
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        piv = col + int(np.nonzero(a[col:, col])[0][0])
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        scale = field.inv(a[col, col])
        a[col] = field.mul(a[col], scale)
        inv[col] = field.mul(inv[col], scale)
        for row in range(n):
            if row != col and a[row, col] != 0:
                f = a[row, col]
                a[row] = field.sub(a[row], field.mul(f, a[col]))
                inv[row] = field.sub(inv[row], field.mul(f, inv[col]))
    return inv


def dft_matrix(field: Field, K: int) -> np.ndarray:
    """D_K (eq. 8): Vandermonde at beta^k, beta = primitive K-th root."""
    beta = field.root_of_unity(K)
    points = np.array([pow(beta, k, field.q) for k in range(K)], np.int64)
    return vandermonde(field, points)


def permuted_dft_matrix(field: Field, K: int, P: int) -> np.ndarray:
    """D_K @ Pi where Pi[k, rev_P(k)] = 1: column k' of D_K lands at rev(k')."""
    H = round(np.log(K) / np.log(P))
    assert P**H == K, f"K={K} must equal P^H"
    d = dft_matrix(field, K)
    out = np.zeros_like(d)
    for k in range(K):
        out[:, digit_reverse(k, P, H)] = d[:, k]
    return out


# ---------------------------------------------------------------------------
# Structured evaluation points for draw-and-loose (Sec. V-B, eq. 15)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StructuredPoints:
    """Evaluation points omega_{i,j} = alpha_i * zeta^{rev(j)} on an M x Z grid.

    Z = P^H divides q-1; alpha_i = g^{phi(i)} with phi injective into
    [0, (q-1)/Z): guarantees all K = M*Z points are distinct (footnote 3).
    Processor k = i*Z + j holds grid cell (row i, col j).
    """

    field: Field
    M: int
    P: int
    H: int
    phi: tuple[int, ...]  # injective map [0,M) -> [0,(q-1)/Z)

    @property
    def Z(self) -> int:
        return self.P**self.H

    @property
    def K(self) -> int:
        return self.M * self.Z

    @property
    def zeta(self) -> int:
        """Primitive Z-th root of unity g^((q-1)/Z)."""
        return self.field.root_of_unity(self.Z) if self.Z > 1 else 1

    def alpha(self, i: int) -> int:
        return int(pow(self.field.generator, self.phi[i], self.field.q))

    def omega(self, i: int, j: int) -> int:
        jr = digit_reverse(j, self.P, self.H)
        return int(self.field.mul(self.alpha(i), pow(self.zeta, jr, self.field.q)))

    def points(self) -> np.ndarray:
        """All K points; index k = i*Z + j."""
        return np.array(
            [self.omega(k // self.Z, k % self.Z) for k in range(self.K)], np.int64
        )

    @staticmethod
    def build(
        field: Field, K: int, P: int = 2, phi_offset: int = 0,
        max_h: int | None = None,
    ) -> "StructuredPoints":
        """Factor K = M * P^H with H maximal s.t. P^H | gcd(K, q-1)
        (optionally capped at max_h)."""
        H = 0
        z = 1
        qm1 = field.q - 1
        while K % (z * P) == 0 and qm1 % (z * P) == 0 and (max_h is None or H < max_h):
            z *= P
            H += 1
        M = K // z
        if M > qm1 // z:
            raise ValueError(f"cannot place M={M} rows into (q-1)/Z={qm1 // z} cosets")
        phi = tuple(phi_offset + i for i in range(M))
        if phi[-1] >= qm1 // z:
            raise ValueError("phi not injective into [0,(q-1)/Z)")
        return StructuredPoints(field, M, P, H, phi)


# ---------------------------------------------------------------------------
# Reed-Solomon / Lagrange constructions (Sec. VI)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SystematicGRS:
    """[N=K+R, K] generalized RS code, eq. (22)-(24).

    alphas (K) and betas (R) are distinct; u (K), v (R) nonzero multipliers.
    `A` is the K x R non-systematic part of G = [I | A].
    """

    field: Field
    alphas: np.ndarray
    betas: np.ndarray
    u: np.ndarray
    v: np.ndarray

    def __post_init__(self):
        pts = np.concatenate([self.alphas, self.betas])
        assert len(set(pts.tolist())) == pts.size, "evaluation points must be distinct"
        assert np.all(self.u % self.field.q != 0) and np.all(self.v % self.field.q != 0)

    @property
    def K(self) -> int:
        return self.alphas.size

    @property
    def R(self) -> int:
        return self.betas.size

    def A_direct(self) -> np.ndarray:
        """A = (V_alpha P)^-1 V_beta Q by explicit inversion (eq. 23)."""
        f = self.field
        va = vandermonde(f, self.alphas)
        vb = vandermonde(f, self.betas, nrows=self.K)
        # V_a P scales column k of V_a by u_k => (V_a P)^-1 = P^-1 V_a^-1
        lhs = f.matmul(np.diag(f.inv(self.u)), gauss_inverse(f, va))
        return f.matmul(f.matmul(lhs, vb), np.diag(f.arr(self.v)))

    def A_cauchy(self) -> np.ndarray:
        """Closed form eq. (24): A[k,r] = c_k d_r / (beta_r - alpha_k)."""
        f = self.field
        K, R = self.K, self.R
        c = np.zeros(K, np.int64)
        for k in range(K):
            diffs = f.sub(self.alphas[k], np.delete(self.alphas, k))
            c[k] = f.mul(f.inv(self.u[k]), f.inv(_prod(f, diffs)))
        d = np.zeros(R, np.int64)
        for r in range(R):
            d[r] = f.mul(self.v[r], _prod(f, f.sub(self.betas[r], self.alphas)))
        denom = f.sub(self.betas[None, :], self.alphas[:, None])
        return f.mul(f.mul(c[:, None], d[None, :]), f.inv(denom))

    def encode(self, x: np.ndarray) -> np.ndarray:
        """x: (K, W) -> parity (R, W) = A^T-applied combination (Def. 1)."""
        return self.field.matmul(self.A_direct().T, x)

    # -- Thm. 6 block decomposition helpers (case K >= R, K = M*R) ----------
    def block_decomposition(self, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Return (alphas_m, phi_m, psi_m, A_m) for block m (Thm. 6).

        A_m = (V_{alpha,m} Phi_m)^-1 V_beta Psi_m, all R x R.
        """
        f = self.field
        R = self.R
        sel = np.arange(m * R, (m + 1) * R)
        a_m = self.alphas[sel]
        others = np.delete(self.alphas, sel)
        phi = np.zeros(R, np.int64)
        psi = np.zeros(R, np.int64)
        for s in range(R):
            phi[s] = f.mul(self.u[m * R + s], _prod(f, f.sub(a_m[s], others)))
            psi[s] = f.mul(self.v[s], _prod(f, f.sub(self.betas[s], others)))
        va_m = vandermonde(f, a_m)
        vb = vandermonde(f, self.betas)
        A_m = f.matmul(
            f.matmul(np.diag(f.inv(phi)), gauss_inverse(f, va_m)),
            f.matmul(vb, np.diag(psi)),
        )
        return a_m, phi, psi, A_m


def _prod(field: Field, xs: np.ndarray) -> int:
    out = np.int64(1)
    for x in np.asarray(xs, np.int64).ravel():
        out = (out * (int(x) % field.q)) % field.q
    return np.int64(out)


def lagrange_matrix(field: Field, alphas, betas) -> np.ndarray:
    """L = V_alpha^-1 V_beta (Remark 9): Cauchy-like with u = v = 1."""
    alphas = field.arr(alphas)
    betas = field.arr(betas)
    va = vandermonde(field, alphas)
    vb = vandermonde(field, betas, nrows=alphas.size)
    return field.matmul(gauss_inverse(field, va), vb)


def structured_grs(field: Field, K: int, R: int, P: int = 2) -> SystematicGRS:
    """A systematic GRS code whose alpha and beta points are *both* structured
    (draw-and-loose applicable): alphas from StructuredPoints at phi offset 0,
    betas at a disjoint offset. Requires the two grids not to collide.
    """
    blk = max(K, R) if (max(K, R) % min(K, R) == 0) else K
    # points for sources: organized for blocks of size R (K>=R) or K (K<R)
    size_a, size_b = K, R
    spa = StructuredPoints.build(field, size_a, P=P, phi_offset=0)
    # offset beta grid beyond alpha grid rows to keep cosets disjoint
    spb = StructuredPoints.build(field, size_b, P=P, phi_offset=spa.M)
    alphas, betas = spa.points(), spb.points()
    both = np.concatenate([alphas, betas])
    if len(set(both.tolist())) != both.size:
        raise ValueError("structured point sets collide; pick different offsets")
    ones_k = np.ones(K, np.int64)
    ones_r = np.ones(R, np.int64)
    return SystematicGRS(field, alphas, betas, ones_k, ones_r)
