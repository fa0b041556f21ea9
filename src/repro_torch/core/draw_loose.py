"""Draw-and-loose: specific A2A for general Vandermonde matrices (Sec. V-B).

For K = M * Z (Z = P^H | q-1) and structured evaluation points
omega_{i,j} = alpha_i * zeta^{j'} (eq. 15), computes x * V where
V[k, i*Z+j] = omega_{i,j}^k:

  draw phase : Z parallel column-wise universal A2As on V_M (eq. 20),
               then a free local scaling by alpha_i^j (eq. 21)
  loose phase: M parallel row-wise permuted-DFT A2As on D_Z Pi (eq. 19)

Cost (Thm. 5): C_univ(M) + C_dft(Z).  Invertible (Lemma 6) by running the
inverse DFT, unscaling, and a universal A2A on V_M^{-1}.
"""
from __future__ import annotations

import numpy as np

from .dft_a2a import cost_dft, dft_a2a
from .field import Field
from .matrices import StructuredPoints, gauss_inverse, vandermonde
from .prepare_shoot import cost_universal, prepare_shoot
from .simulator import run_lockstep


def _v_m(field: Field, sp: StructuredPoints) -> np.ndarray:
    """V_M of eq. (20): V_M[l, i] = alpha_i^(Z*l)."""
    alphas_z = np.array(
        [pow(sp.alpha(i), sp.Z, field.q) for i in range(sp.M)], np.int64
    )
    return vandermonde(field, alphas_z)


def draw_loose(
    field: Field,
    sp: StructuredPoints,
    x: dict[int, np.ndarray],
    procs: list[int],
    p: int,
    out: dict[int, np.ndarray],
    inverse: bool = False,
):
    """Generator schedule: out = x * V (or x * V^-1), V the K x K Vandermonde
    at sp.points(); local index k = i*Z + j sits at grid (row i, col j)."""
    M, Z, P = sp.M, sp.Z, sp.P
    K = M * Z
    assert len(procs) == K
    vals = {k: field.arr(x[procs[k]]) for k in range(K)}

    def col_procs(j):
        return [procs[i * Z + j] for i in range(M)]

    def row_procs(i):
        return [procs[i * Z + j] for j in range(Z)]

    def run_draw(mat):
        gens = []
        stage_out: dict[int, np.ndarray] = {}
        for j in range(Z):
            gx = {procs[i * Z + j]: vals[i * Z + j] for i in range(M)}
            gens.append(prepare_shoot(field, mat, gx, col_procs(j), p, stage_out))
        return gens, stage_out

    def run_loose(inv):
        gens = []
        stage_out: dict[int, np.ndarray] = {}
        for i in range(M):
            gx = {procs[i * Z + j]: vals[i * Z + j] for j in range(Z)}
            gens.append(
                dft_a2a(field, gx, row_procs(i), p, P, stage_out, inverse=inv)
            )
        return gens, stage_out

    def scale(invert):
        for i in range(M):
            for j in range(Z):
                s = pow(sp.alpha(i), j, field.q)
                if invert:
                    s = int(field.inv(s))
                vals[i * Z + j] = field.mul(vals[i * Z + j], s)

    if not inverse:
        # ---- draw: column A2A on V_M, then local scale alpha_i^j ----------
        if M > 1:
            gens, so = run_draw(_v_m(field, sp))
            yield from run_lockstep(*gens)
            for k in range(K):
                vals[k] = so[procs[k]]
        scale(invert=False)
        # ---- loose: row-wise permuted DFT ---------------------------------
        if Z > 1:
            gens, so = run_loose(inv=False)
            yield from run_lockstep(*gens)
            for k in range(K):
                vals[k] = so[procs[k]]
    else:
        # ---- inverse loose --------------------------------------------------
        if Z > 1:
            gens, so = run_loose(inv=True)
            yield from run_lockstep(*gens)
            for k in range(K):
                vals[k] = so[procs[k]]
        scale(invert=True)
        # ---- inverse draw ---------------------------------------------------
        if M > 1:
            gens, so = run_draw(gauss_inverse(field, _v_m(field, sp)))
            yield from run_lockstep(*gens)
            for k in range(K):
                vals[k] = so[procs[k]]

    for k in range(K):
        out[procs[k]] = vals[k]


def cost_draw_loose(sp: StructuredPoints, p: int) -> tuple[int, int]:
    """(C1, C2) per Thm. 5: C_univ(M) + C_dft(Z)."""
    c1u, c2u = cost_universal(sp.M, p)
    c1d, c2d = cost_dft(sp.Z, sp.P, p) if sp.Z > 1 else (0, 0)
    return c1u + c1d, c2u + c2d
