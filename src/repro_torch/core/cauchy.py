"""All-to-all encode for Cauchy-like matrices — systematic Reed-Solomon and
Lagrange codes (Sec. VI, Thms. 6-9, Remark 9).

Thm. 6: for a systematic GRS code [I | A] with A = (V_alpha P)^-1 V_beta Q,
every R x R block A_m of A (case K >= R, eq. 1) factors as

    A_m = (V_{alpha,m} Phi_m)^-1  V_beta  Psi_m

so processor group m computes x * A_m by:
    1. local scale by phi_{m,s}^-1          (free)
    2. inverse draw-and-loose on V_{alpha,m}  (Lemma 6)
    3. forward draw-and-loose on V_beta
    4. local scale by psi_r                  (free)

This requires the alpha points of every block and the beta points to be
*structured* (eq. 15) — `StructuredGRS.build` constructs such codes, placing
each block's alpha grid and the beta grid in disjoint generator cosets so all
K + R evaluation points stay distinct.

Cost (Thm. 7): C1 = 2*ceil(log_{p+1} R); C2 = C2(V_alpha,m) + C2(V_beta).

Lagrange matrices (Remark 9) are the u = v = 1 case and reuse this machinery.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .draw_loose import cost_draw_loose, draw_loose
from .field import Field
from .matrices import StructuredPoints, SystematicGRS, _prod


@dataclass(frozen=True)
class StructuredGRS:
    """Systematic GRS code whose evaluation points are draw-and-loose ready.

    Case K >= R (K = M*R): alpha block m (size R) is `alpha_blocks[m]`;
    betas are one structured R-point set.
    Case K < R (R = M*K): alphas are one structured K-point set; beta block m
    (size K) is `beta_blocks[m]`.
    """

    grs: SystematicGRS
    alpha_blocks: tuple[StructuredPoints, ...]
    beta_blocks: tuple[StructuredPoints, ...]

    @property
    def field(self) -> Field:
        return self.grs.field

    @property
    def K(self) -> int:
        return self.grs.K

    @property
    def R(self) -> int:
        return self.grs.R

    @staticmethod
    def build(field: Field, K: int, R: int, P: int = 2, lagrange: bool = False) -> "StructuredGRS":
        """Build a structured systematic GRS (or Lagrange, u=v=1) code.

        Requires min | max of (K, R). Blocks get consecutive phi offsets so
        every evaluation point g^(o+i) * zeta^{j'} is distinct.
        """
        big, small = max(K, R), min(K, R)
        assert big % small == 0, "assume K | R or R | K (Remark 4)"
        n_small_sets = big // small + 1  # M blocks of the big side + 1 small set

        # factor `small` = M_s * P^H against q-1
        proto = StructuredPoints.build(field, small, P=P, phi_offset=0)
        rows_per_set = proto.M
        sets = []
        for b in range(n_small_sets):
            sets.append(
                StructuredPoints(field, proto.M, proto.P, proto.H,
                                 tuple(b * rows_per_set + i for i in range(proto.M)))
            )
        if (n_small_sets) * rows_per_set > (field.q - 1) // proto.Z:
            raise ValueError("not enough cosets in F_q for this (K, R)")

        if K >= R:
            alpha_blocks = tuple(sets[:-1])
            beta_blocks = (sets[-1],)
            alphas = np.concatenate([s.points() for s in alpha_blocks])
            betas = beta_blocks[0].points()
        else:
            alpha_blocks = (sets[-1],)
            beta_blocks = tuple(sets[:-1])
            alphas = alpha_blocks[0].points()
            betas = np.concatenate([s.points() for s in beta_blocks])
        u = np.ones(K, np.int64)
        v = np.ones(R, np.int64)
        grs = SystematicGRS(field, alphas, betas, u, v)
        return StructuredGRS(grs, alpha_blocks, beta_blocks)

    # ------------------------------------------------------------------
    def scaling_factors(self, m: int) -> tuple[np.ndarray, np.ndarray]:
        """(phi_m, psi_m) of eqs. (26)-(27) (case K>=R) or the K<R analogue
        from Thm. 8: A_m = (P V_alpha)^-1 V_{beta,m} Q_m."""
        f, grs = self.field, self.grs
        if self.K >= self.R:
            R = self.R
            sel = np.arange(m * R, (m + 1) * R)
            others = np.delete(grs.alphas, sel)
            phi = np.array(
                [f.mul(grs.u[m * R + s], _prod(f, f.sub(grs.alphas[m * R + s], others)))
                 for s in range(R)], np.int64)
            psi = np.array(
                [f.mul(grs.v[r], _prod(f, f.sub(grs.betas[r], others)))
                 for r in range(R)], np.int64)
            return phi, psi
        else:
            # Thm. 8: full V_alpha inverse, block of betas; phi has no
            # excluded indices (S_m covers nothing of alphas)
            K = self.K
            sel = np.arange(m * K, (m + 1) * K)
            phi = np.array(
                [f.mul(grs.u[s], np.int64(1)) for s in range(K)], np.int64)
            psi = np.array([grs.v[r] for r in sel], np.int64)
            return phi, psi


def cauchy_a2a(
    sgrs: StructuredGRS,
    m: int,
    x: dict[int, np.ndarray],
    procs: list[int],
    p: int,
    out: dict[int, np.ndarray],
):
    """Generator schedule computing x * A_m on one processor group.

    Group size is R (case K>=R, Thm. 7) or K (case K<R, Thm. 9).
    """
    f = sgrs.field
    phi, psi = sgrs.scaling_factors(m)
    if sgrs.K >= sgrs.R:
        sp_in, sp_out = sgrs.alpha_blocks[m], sgrs.beta_blocks[0]
    else:
        sp_in, sp_out = sgrs.alpha_blocks[0], sgrs.beta_blocks[m]
    n = len(procs)
    assert n == sp_in.K == sp_out.K

    # 1. local scale by phi^-1
    vals = {procs[k]: f.mul(f.inv(phi[k]), f.arr(x[procs[k]])) for k in range(n)}
    # 2. inverse draw-and-loose on V_alpha(,m)
    mid: dict[int, np.ndarray] = {}
    yield from draw_loose(f, sp_in, vals, procs, p, mid, inverse=True)
    # 3. forward draw-and-loose on V_beta(,m)
    fin: dict[int, np.ndarray] = {}
    yield from draw_loose(f, sp_out, mid, procs, p, fin)
    # 4. local scale by psi
    for k in range(n):
        out[procs[k]] = f.mul(psi[k], fin[procs[k]])


def lagrange_a2a(field: Field, K: int, R: int, x, procs, p, out, P: int = 2):
    """Remark 9 convenience: Lagrange matrix A2A (u=v=1), systematic when
    alpha_k = beta_k. Returns the schedule for the single square block."""
    sgrs = StructuredGRS.build(field, K, R, P=P, lagrange=True)
    return cauchy_a2a(sgrs, 0, x, procs, p, out)


def cost_cauchy(sgrs: StructuredGRS, m: int, p: int) -> tuple[int, int]:
    """(C1, C2) per Thm. 7/9: two draw-and-looses."""
    if sgrs.K >= sgrs.R:
        sp_in, sp_out = sgrs.alpha_blocks[m], sgrs.beta_blocks[0]
    else:
        sp_in, sp_out = sgrs.alpha_blocks[0], sgrs.beta_blocks[m]
    c1a, c2a = cost_draw_loose(sp_in, p)
    c1b, c2b = cost_draw_loose(sp_out, p)
    return c1a + c1b, c2a + c2b
