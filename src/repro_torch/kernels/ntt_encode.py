"""O(K log K) local encode via NTTs — the fast path behind the planner.

The dense local encode is `kernels.ops.encode_blocks` (an O(K^2 W) field
matmul).  Two spec families admit an exact O(K log K * W) route through the
radix-2 NTT kernel (`csrc/ntt.cu`) instead:

* kind="dft" (P = 2): the generator *is* the permuted DFT matrix D_K Pi,
  and `ntt` computes x^T (D_K Pi) directly (validated bitwise in tests).

* kind="rs"/"lagrange" from `StructuredGRS.build`: when every structured
  point set is a *single coset* of the Z-th roots of unity (Z = the small
  side of (K, R), a power of two), the Thm. 6/8 block factorization

      A_m = (V_{alpha,m} Phi_m)^-1 V_beta Psi_m

  turns into scaled NTTs.  With alpha block m = { c_m * zeta^rev(j) } and
  beta set { c_b * zeta^rev(j) }, the Vandermonde at the block is
  V = diag(c^i) (D_Z Pi), so

      y_m = Psi_m . NTT( e_m . INTT( Phi_m^-1 . x_m ) ),
      e_m[i] = (c_b / c_m)^i                       (the coset twist)

  and parity is sum_m y_m (case K >= R) or the concatenation over beta
  blocks (case K < R).  Total: O(K log Z) field ops per payload column
  vs O(K * R) for the matmul.

Everything is exact integer arithmetic mod q, so the fast path is bitwise
identical to `encode_blocks` with `A_direct()` — the planner can switch
freely (`EncodePlan.local_impl`).  Applicability is structural
(`NTTEncodeParams.build` returns None when it does not hold), which in
practice means: min(K, R) is a power of two >= 2 dividing q - 1, P == 2,
and q is the Fermat prime.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.field import FERMAT_Q, fermat_mul, fermat_reduce
from .ntt import ntt


def _pow_vec(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, base^1, ..., base^(n-1)] mod q."""
    out = np.empty(n, np.int64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * base % q
    return out


def _single_coset(sp) -> bool:
    """One alpha row (M == 1), radix-2, nontrivial transform size."""
    return sp.M == 1 and sp.P == 2 and sp.Z >= 2


@dataclass(frozen=True)
class NTTEncodeParams:
    """Host-side constants of the NTT fast path (cached on HostTables).

    kind="dft": the transform is one forward NTT; every other field unused.
    kind="grs": Z is the block transform size (min(K, R)), M the block
    count; phi_inv/psi/twist are (M, Z) per-block scale vectors and
    `case_kge` selects the K >= R (sum over blocks) vs K < R (concatenate
    over beta blocks) combination rule.
    """

    kind: str                       # "dft" | "grs"
    K: int
    R: int
    Z: int = 0
    M: int = 1
    case_kge: bool = True
    phi_inv: np.ndarray | None = None   # (M, Z) int64
    psi: np.ndarray | None = None       # (M, Z) int64
    twist: np.ndarray | None = None     # (M, Z) int64  e_m[i] = (c_b/c_m)^i
    # device -> (phi_inv, psi, twist) as (Z, M, 1) tensors, made once: a
    # pageable copy per call would synchronise the stream it runs on
    _dev: dict = field(default_factory=dict, compare=False, repr=False)

    def on(self, device) -> tuple:
        """(phi_inv, psi, twist) as (Z, M, 1) int64 tensors on `device`."""
        hit = self._dev.get(device)
        if hit is None:
            hit = self._dev[device] = tuple(
                torch.as_tensor(a.T, device=device)[:, :, None]
                for a in (self.phi_inv, self.psi, self.twist))
        return hit

    @staticmethod
    def build(spec, sgrs) -> "NTTEncodeParams | None":
        """Params for the spec's local fast path, or None if inapplicable."""
        if spec.q != FERMAT_Q:
            return None
        if spec.kind == "dft":
            if spec.P != 2 or spec.K < 2:
                return None
            return NTTEncodeParams("dft", spec.K, spec.R)
        if sgrs is None:
            return None
        f = sgrs.field
        g = f.generator
        blocks = sgrs.alpha_blocks + sgrs.beta_blocks
        if not all(_single_coset(sp) for sp in blocks):
            return None
        K, R = sgrs.K, sgrs.R
        Z = min(K, R)
        if any(sp.Z != Z for sp in blocks):
            return None
        case_kge = K >= R
        M = max(K, R) // Z
        phi_inv = np.empty((M, Z), np.int64)
        psi = np.empty((M, Z), np.int64)
        twist = np.empty((M, Z), np.int64)
        if case_kge:
            c_beta = pow(g, sgrs.beta_blocks[0].phi[0], f.q)
            for m, ab in enumerate(sgrs.alpha_blocks):
                p_m, s_m = sgrs.scaling_factors(m)
                phi_inv[m], psi[m] = f.inv(p_m), s_m
                c_m = pow(g, ab.phi[0], f.q)
                twist[m] = _pow_vec(int(f.mul(c_beta, f.inv(np.int64(c_m)))),
                                    Z, f.q)
        else:
            c_alpha = pow(g, sgrs.alpha_blocks[0].phi[0], f.q)
            for m, bb in enumerate(sgrs.beta_blocks):
                p_m, s_m = sgrs.scaling_factors(m)
                phi_inv[m], psi[m] = f.inv(p_m), s_m
                c_b = pow(g, bb.phi[0], f.q)
                twist[m] = _pow_vec(int(f.mul(c_b, f.inv(np.int64(c_alpha)))),
                                    Z, f.q)
        return NTTEncodeParams("grs", K, R, Z, M, case_kge,
                               phi_inv, psi, twist)


def ntt_encode(x: torch.Tensor, params: NTTEncodeParams) -> torch.Tensor:
    """Encode payload x (K, W) int32 -> sink values (R, W) int32.

    Bitwise-equal to `encode_blocks(x, A_direct())`.  The NTTs run on x's
    device (the CUDA kernel, or its plain version on the CPU); the scalings
    between them are int64 torch arithmetic on the same device.
    """
    if params.kind == "dft":
        return ntt(x)
    Z, M, W = params.Z, params.M, x.shape[1]

    def i32(t):
        return t.to(torch.int32).contiguous()

    def scaled(scale, t):
        """scale * t mod q as a new int64 tensor, multiplied and reduced in
        place: `fermat_mul` without its two int64 temporaries (a product
        of two field elements is below 2^32, exact in int64)."""
        return t.to(torch.int64, copy=True).mul_(scale).remainder_(FERMAT_Q)

    phi_inv, psi, twist = params.on(x.device)
    if params.case_kge:
        # blocks side by side in one batched transform: (Z, M*W) columns;
        # one int64 buffer live at a time (a parameter tree's 1.7e9
        # symbols at rs 8/2 are 13.8 GB in int64)
        t = scaled(phi_inv, x.reshape(M, Z, W).transpose(0, 1))
        t = ntt(i32(t).reshape(Z, M * W), inverse=True)
        t = ntt(i32(scaled(twist, t.reshape(Z, M, W))).reshape(Z, M * W))
        return i32(fermat_reduce(scaled(psi, t.reshape(Z, M, W)).sum(dim=1)))
    # K < R: one interpolation, M twisted evaluations (beta blocks)
    t0 = ntt(i32(fermat_mul(phi_inv[:, 0], x)), inverse=True)   # (K, W)
    tb = fermat_mul(twist, t0[:, None, :])                      # (K, M, W)
    y = ntt(i32(tb).reshape(Z, M * W)).reshape(Z, M, W)
    y = fermat_mul(psi, y)
    return i32(y.transpose(0, 1).reshape(params.R, W))
