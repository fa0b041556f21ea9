"""Specific all-to-all encode for (permuted) DFT matrices (Sec. V-A).

For K = P^H with K | q-1, computes x * (D_K @ Pi) where Pi is the base-P
digit-reversal column permutation: processor P_k ends with f(beta^{k'}),
k' = digit_reverse(k).  H stages; stage h runs K/P parallel P-sized all-to-all
encodes (prepare-and-shoot) on the Vandermonde matrices A_k^{(h)} of eq. (14),
whose points are the gamma tree elements of eq. (9)-(10).

Cost: H * C_univ(P)  (Thm. 4); when P = p+1 each stage is a single round of
1-element messages, so C = H * (alpha + beta*log2 q) — strictly optimal
(Cor. 1).  The algorithm is invertible stage-by-stage (Lemma 5).
"""
from __future__ import annotations

import numpy as np

from .field import Field
from .matrices import gauss_inverse, vandermonde
from .prepare_shoot import cost_universal, prepare_shoot
from .simulator import run_lockstep


def _stage_groups(K: int, P: int, H: int, h: int):
    """Groups for stage h (0-indexed): members differ in k-digit (H-h), i.e.
    position P^(H-h-1); the top h digits of k form the shared gamma prefix."""
    pos = P ** (H - h - 1)
    groups = []
    for base in range(K):
        if (base // pos) % P != 0:
            continue
        members = [base + rho * pos for rho in range(P)]
        groups.append(members)
    return groups


def _stage_matrix(field: Field, K: int, P: int, H: int, h: int, member0: int) -> np.ndarray:
    """A^{(h)} of eq. (14) for the group containing `member0`.

    gamma_rho = beta^((rho*P^h + prefix) * K / P^(h+1)), prefix = value of the
    top h digits of k read as the low digits of k' (eq. 9).
    """
    beta = field.root_of_unity(K)
    # top h digits of k (shared in group) -> k'_1..k'_h (low digits of k')
    prefix = 0
    kk = member0 // (P ** (H - h))  # top h digits as an integer, MSD..(H-h+1)
    # k digits at positions H, H-1, ..., H-h+1 (1-indexed LSF) map to
    # k'_1, k'_2, ..., k'_h: prefix = sum_j k'_j P^(j-1)
    top_digits = []
    for _ in range(h):
        top_digits.append(kk % P)
        kk //= P
    # top_digits[0] = digit H-h+1 of k = k'_h, ..., top_digits[h-1] = digit H = k'_1
    for j, d in enumerate(reversed(top_digits)):  # now k'_1 first
        prefix += d * P**j
    exp_scale = K // P ** (h + 1)
    gammas = [pow(beta, (rho * P**h + prefix) * exp_scale, field.q) for rho in range(P)]
    return vandermonde(field, np.array(gammas, np.int64))


def dft_a2a(
    field: Field,
    x: dict[int, np.ndarray],
    procs: list[int],
    p: int,
    P: int,
    out: dict[int, np.ndarray],
    inverse: bool = False,
):
    """Generator schedule: out[g] = (x * D'_K)[local index of g], D'_K = D_K Pi.

    With inverse=True computes x * D'_K^{-1} (Lemma 5).
    """
    K = len(procs)
    H = 0
    while P**H < K:
        H += 1
    assert P**H == K, f"K={K} must be a power of P={P}"
    assert (field.q - 1) % K == 0, "needs K | q-1"

    vals = {k: field.arr(x[procs[k]]) for k in range(K)}
    stages = range(H - 1, -1, -1) if inverse else range(H)
    for h in stages:
        groups = _stage_groups(K, P, H, h)
        gens = []
        stage_out: dict[int, np.ndarray] = {}
        for members in groups:
            mat = _stage_matrix(field, K, P, H, h, members[0])
            if inverse:
                mat = gauss_inverse(field, mat)
            gx = {procs[m]: vals[m] for m in members}
            gens.append(
                prepare_shoot(field, mat, gx, [procs[m] for m in members], p, stage_out)
            )
        yield from run_lockstep(*gens)
        for k in range(K):
            vals[k] = stage_out[procs[k]]
    for k in range(K):
        out[procs[k]] = vals[k]


def cost_dft(K: int, P: int, p: int) -> tuple[int, int]:
    """(C1, C2) of the DFT-specific algorithm (Thm. 4): H * C_univ(P)."""
    H = 0
    while P**H < K:
        H += 1
    c1, c2 = cost_universal(P, p)
    return H * c1, H * c2
