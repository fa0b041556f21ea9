"""Mesh parity encode (Sec. III-A framework across the processors) and
any-K-of-N reconstruction of a structured GRS codeword (`reconstruct`).

N processors each hold one state shard x_k (k = processor index); R parity
symbols of the systematic [N+R, N] GRS code must land on processors 0..R-1
(which also keep their own data shards — rotating-parity style double
duty; any f <= R/2 processor failures erase at most 2f codeword symbols and
remain decodable; with parity *offloaded to a checkpoint store* any R
erasures are decodable).

Phase 1 — column-wise all-to-all encode: processors form an R x M grid
(column m = processors [mR, (m+1)R), M = N/R); each column computes its
R x R block A_m of A.  Implemented either with the universal
prepare-and-shoot tables ('universal') or the Thm. 7 Cauchy-like pipeline
('rs': scale phi^-1 -> inverse draw-and-loose on V_{alpha,m} -> forward
draw-and-loose on V_beta -> scale psi).

Phase 2 — row-wise (p+1)-nomial reduce onto the column-0 processor of each
row.

The table builders are copies of the JAX package's `core/parity.py`
(numpy, equal array for array); `mesh_parity_encode` runs on this rank's
block of a `core.shardmap_exec.ProcMesh`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .cauchy import StructuredGRS
from .field import FERMAT_Q, Field
from .matrices import StructuredPoints, gauss_inverse
from .shardmap_exec import (
    DFTTables,
    ProcMesh,
    UniversalTables,
    _add,
    _mul,
    _v_m_matrix,
    build_dft_tables,
    build_universal_tables,
    mesh_dft,
    mesh_universal_a2a,
    universal_rows,
)


@dataclass(frozen=True)
class ParityTables:
    """Everything the parity-encode step needs, precomputed host-side.

    `sgrs` is None when the tables were built from an arbitrary (non-GRS)
    generator block via `build_encode_tables(..., method="universal")`.
    """

    N: int
    R: int
    M: int
    p: int
    method: str
    sgrs: StructuredGRS | None
    # universal path
    univ: UniversalTables | None
    # rs path: inverse DL on alpha blocks + forward DL on beta
    dl_scale_pre: np.ndarray | None    # (N,) phi^-1
    dl_inv_univ: UniversalTables | None
    dl_inv_dft: DFTTables | None
    dl_inv_scale: np.ndarray | None
    dl_fwd_univ: UniversalTables | None
    dl_fwd_dft: DFTTables | None
    dl_fwd_scale: np.ndarray | None
    dl_scale_post: np.ndarray | None   # (N,) psi
    reduce_mask: np.ndarray            # (T_red, p, N) uint32

    def device_arrays(self) -> dict[str, np.ndarray]:
        """The (N, ...) per-processor tables, keyed as the reference keys
        its sharded step inputs."""
        out = {"reduce_mask": np.moveaxis(self.reduce_mask, -1, 0)}  # (N, T, p)
        if self.method == "universal":
            out["u_coef"] = self.univ.coef
            out["u_corr"] = self.univ.corr
        else:
            out["pre"] = self.dl_scale_pre
            out["post"] = self.dl_scale_post
            out["i_scale"] = self.dl_inv_scale
            out["f_scale"] = self.dl_fwd_scale
            if self.dl_inv_univ is not None:
                out["i_coef"] = self.dl_inv_univ.coef
                out["i_corr"] = self.dl_inv_univ.corr
            if self.dl_inv_dft is not None:
                out["i_ca"] = self.dl_inv_dft.ca.T  # (N, H)
                out["i_cb"] = self.dl_inv_dft.cb.T
            if self.dl_fwd_univ is not None:
                out["f_coef"] = self.dl_fwd_univ.coef
                out["f_corr"] = self.dl_fwd_univ.corr
            if self.dl_fwd_dft is not None:
                out["f_ca"] = self.dl_fwd_dft.ca.T
                out["f_cb"] = self.dl_fwd_dft.cb.T
        return out

    def device_rows(self, mesh: ProcMesh) -> dict[str, torch.Tensor]:
        """This rank's rows of `device_arrays()` on the mesh's device, with
        each universal stage's coef and corr stacked into one
        (K/G, n_pad + 1, m) operand (`universal_rows`)."""
        arrs = self.device_arrays()
        rows = {k: mesh.rows(v) for k, v in arrs.items()
                if not k.endswith(("_coef", "_corr"))}
        for key, t in (("u", self.univ), ("i", self.dl_inv_univ),
                       ("f", self.dl_fwd_univ)):
            if f"{key}_coef" in arrs:
                rows[f"{key}_cc"] = universal_rows(t, mesh)
        for key in ("pre", "post", "i_scale", "f_scale"):
            if key in rows:
                rows[key] = rows[key][:, None]
        return rows


def _build_grid_draw_loose(
    field: Field,
    sps: list[StructuredPoints],
    p: int,
    inverse: bool,
) -> tuple[UniversalTables | None, DFTTables | None, np.ndarray]:
    """Draw-and-loose tables for several grids along the axis, one
    StructuredPoints per grid (they must share M, Z, P)."""
    sp0 = sps[0]
    M, Z = sp0.M, sp0.Z
    K = M * Z
    N = len(sps) * K
    univ = None
    if M > 1:
        mats = []
        # group id for (grid g, column j) = g*Z + j
        for g in range(len(sps)):
            vm = _v_m_matrix(field, sps[g])
            if inverse:
                vm = gauss_inverse(field, vm)
            mats.extend([vm] * Z)
        univ = build_universal_tables(field, mats, N, p, group_stride=Z)
    dft = None
    if Z > 1:
        dft = build_dft_tables(field, N, Z, group_stride=1, inverse=inverse)
    scale = np.zeros(N, np.uint32)
    for dev in range(N):
        g, k = dev // K, dev % K
        i, j = k // Z, k % Z
        s = pow(sps[g].alpha(i), j, field.q)
        if inverse:
            s = pow(s, field.q - 2, field.q)
        scale[dev] = s
    return univ, dft, scale


def build_parity_tables(
    field: Field, N: int, R: int, p: int = 1, method: str = "rs"
) -> ParityTables:
    """Systematic [N+R, N] GRS parity across N processors, R | N."""
    sgrs = StructuredGRS.build(field, N, R, P=2)
    return build_encode_tables(field, sgrs.grs.A_direct(), p=p, method=method,
                               sgrs=sgrs)


def build_encode_tables(
    field: Field,
    A: np.ndarray,
    p: int = 1,
    method: str = "universal",
    sgrs: StructuredGRS | None = None,
) -> ParityTables:
    """Mesh-encode tables for an arbitrary (K, R) generator block A, R | K.

    The K processors hold the sources; sink r overlays processor r
    (Sec. III-A with borrowed sinks).  method="universal" works for ANY A;
    method="rs" additionally needs the StructuredGRS code A came from
    (Thm. 7 factorization).  This is the single table builder behind both
    `build_parity_tables` and the `api` mesh backend.
    """
    A = field.arr(A)
    N, R = A.shape
    assert N % R == 0, "R must divide the axis size"
    M = N // R

    univ = None
    pre = post = i_scale = f_scale = None
    i_univ = i_dft = f_univ = f_dft = None
    if method == "universal":
        mats = [A[m * R : (m + 1) * R, :] for m in range(M)]
        univ = build_universal_tables(field, mats, N, p, group_stride=1)
    elif method == "rs":
        assert sgrs is not None and sgrs.K == N and sgrs.R == R, \
            "method='rs' needs the StructuredGRS code A was built from"
        pre = np.zeros(N, np.uint32)
        post = np.zeros(N, np.uint32)
        for m in range(M):
            phi, psi = sgrs.scaling_factors(m)
            for s in range(R):
                pre[m * R + s] = pow(int(phi[s]), field.q - 2, field.q)
                post[m * R + s] = int(psi[s])
        i_univ, i_dft, i_scale = _build_grid_draw_loose(
            field, list(sgrs.alpha_blocks), p, inverse=True
        )
        f_univ, f_dft, f_scale = _build_grid_draw_loose(
            field, [sgrs.beta_blocks[0]] * M, p, inverse=False
        )
    else:
        raise ValueError(method)

    # phase-2 reduce masks: rows = {r, r+R, ...}, reduce onto position 0
    T_red = max(1, math.ceil(math.log(M, p + 1))) if M > 1 else 0
    mask = np.zeros((T_red, p, N), np.uint32)
    for t in range(1, T_red + 1):
        blk = (p + 1) ** t
        sub = (p + 1) ** (t - 1)
        for dev in range(N):
            j = dev // R  # position within the row group (stride R)
            for rho in range(1, p + 1):
                if j % blk == 0 and (j + rho * sub) < M:
                    mask[t - 1, rho - 1, dev] = 1
    return ParityTables(
        N, R, M, p, method, sgrs, univ,
        pre, i_univ, i_dft, i_scale, f_univ, f_dft, f_scale, post, mask,
    )


def mesh_parity_encode(x: torch.Tensor, rows: dict, t: ParityTables,
                       mesh: ProcMesh) -> torch.Tensor:
    """Body: x (K/G, W) int32 block -> (K/G, W), where processors 0..R-1
    end up holding parity symbols 0..R-1 (the others return partial
    garbage that callers mask out).  `rows` is `t.device_rows(mesh)`."""
    v = x

    # ---- phase 1: column-wise A2A on A_m ---------------------------------
    if t.method == "universal":
        v = mesh_universal_a2a(v, rows["u_cc"], t.univ, mesh)
    else:
        v = _mul(rows["pre"], v)
        # inverse draw-and-loose on V_{alpha,m}
        if t.dl_inv_dft is not None:
            v = mesh_dft(v, rows["i_ca"], rows["i_cb"], t.dl_inv_dft, mesh,
                         inverse=True)
        v = _mul(rows["i_scale"], v)
        if t.dl_inv_univ is not None:
            v = mesh_universal_a2a(v, rows["i_cc"], t.dl_inv_univ, mesh)
        # forward draw-and-loose on V_beta
        if t.dl_fwd_univ is not None:
            v = mesh_universal_a2a(v, rows["f_cc"], t.dl_fwd_univ, mesh)
        v = _mul(rows["f_scale"], v)
        if t.dl_fwd_dft is not None:
            v = mesh_dft(v, rows["f_ca"], rows["f_cb"], t.dl_fwd_dft, mesh)
        v = _mul(rows["post"], v)

    # ---- phase 2: row-wise reduce onto column 0 ---------------------------
    R, M, p = t.R, t.M, t.p
    T_red = t.reduce_mask.shape[0]
    for tt in range(1, T_red + 1):
        sub = (p + 1) ** (tt - 1)
        for rho in range(1, p + 1):
            recv = mesh.group_perm(v, R, M, -rho * sub)
            mask = rows["reduce_mask"][:, tt - 1, rho - 1, None]  # 0 or 1
            v = _add(v, recv * mask)
    return v


def reconstruct(field: Field, sgrs: StructuredGRS, kept: np.ndarray,
                vals: np.ndarray, *, device=None) -> np.ndarray:
    """Any-K-of-N decode: kept (K,) codeword indices, vals (K, W) symbols
    -> the (K, W) data as numpy int64.

    For the Fermat field the solve runs on `kernels.gf_solve` on `device`
    (None means "cuda"; exact Gauss-Jordan inverse, then the `gf_matmul`
    kernel); other fields keep the exact numpy host path and touch no
    device.  Both are exact mod q, so the result is bitwise identical
    either way.
    """
    K = sgrs.K
    A = sgrs.grs.A_direct()
    G = np.concatenate([np.eye(K, dtype=np.int64), A], axis=1)
    sub = G[:, kept]  # K x K
    if field.q == FERMAT_Q:
        from ..kernels.gf_solve import gf_solve

        x = gf_solve(sub.T % FERMAT_Q, field.arr(vals), device=device)
        return x.cpu().numpy().astype(np.int64)
    return field.matmul(gauss_inverse(field, sub.T), field.arr(vals))
