"""The general decentralized-encoding framework (Sec. III + Appendix B).

Global processor ids: sources S_k = k (k in [0, K)), sinks T_r = K + r
(r in [0, R)).  Given the non-systematic part A (K x R) of G = [I | A] and
source payloads x (K, W), every sink T_r must obtain x^T A[:, r].

Case K >= R (Sec. III-A): sources form an R x M grid (M = ceil(K/R), position
k = r + m*R at row r / column m); sinks are borrowed (holding 0) to pad the
last column.  Phase 1: M parallel column-wise A2As on the R x R blocks A'_m;
phase 2: R parallel row-wise all-to-one reduces into each sink.

Case K < R (Sec. III-B): sinks form a K x M grid (M = ceil(R/K)); sources are
appended as an extra column and borrowed to pad unfilled rows.  Phase 1: K
parallel row-wise broadcasts of x_k; phase 2: M parallel column-wise A2As on
the K x K blocks A'_m.

Appendix B (non-systematic G, K x N): sinks hold 0 and the system runs one
big A2A on the padded square G' (case K > R), or row-broadcasts + column A2As
on padded square blocks (case K <= R).

The per-block A2A is pluggable: 'universal' (prepare-and-shoot, any A) or
'rs' (Cauchy-like two-phase draw-and-loose, Thm. 7/9 — requires a
StructuredGRS).

The planners no longer drive these generators directly: `core.schedule`'s
builders transcribe them round-for-round into a backend-neutral `RoundIR`
(byte-exact round structure, asserted by golden-digest tests), and all
backends lower that IR.  `decentralized_encode` remains the
paper-fidelity reference body and the shim for direct callers.

A copy of the JAX package's `core/framework.py` (pure numpy), kept so that
the port imports nothing of it.
"""
from __future__ import annotations

import math

import numpy as np

from . import collectives
from .cauchy import StructuredGRS, cauchy_a2a
from .field import Field
from .prepare_shoot import prepare_shoot
from .simulator import RoundNetwork, run_lockstep


def _pad_rows(field: Field, A: np.ndarray, rows: int) -> np.ndarray:
    """Append an arbitrary matrix B (zeros — the choice is immaterial since
    borrowed processors hold 0) to make A have `rows` rows."""
    K, R = A.shape
    if rows == K:
        return field.arr(A)
    return np.concatenate([field.arr(A), np.zeros((rows - K, R), np.int64)])


def decentralized_encode(
    field: Field,
    A: np.ndarray,
    x: np.ndarray,
    p: int = 1,
    method: str = "universal",
    sgrs: StructuredGRS | None = None,
    net: RoundNetwork | None = None,
) -> tuple[np.ndarray, RoundNetwork]:
    """Run the full framework; returns (sink values (R, W), network)."""
    A = field.arr(A)
    K, R = A.shape
    x = field.arr(x)
    assert x.shape[0] == K
    N = K + R
    net = net or RoundNetwork(N, p)
    if method == "rs":
        assert sgrs is not None and sgrs.K == K and sgrs.R == R
        ref = sgrs.grs.A_direct()
        assert np.array_equal(ref, A), "A must come from the StructuredGRS code"

    if K >= R:
        M = math.ceil(K / R)
        Ap = _pad_rows(field, A, M * R)

        def pos_proc(r: int, m: int) -> int:
            k = r + m * R
            return k if k < K else K + r  # borrowed sink T_r holds 0

        def pos_val(r: int, m: int) -> np.ndarray:
            k = r + m * R
            return x[k] if k < K else np.zeros_like(x[0])

        # ---- phase 1: column-wise A2A --------------------------------
        partial: dict[int, np.ndarray] = {}
        gens = []
        for m in range(M):
            procs = [pos_proc(r, m) for r in range(R)]
            vals = {pos_proc(r, m): pos_val(r, m) for r in range(R)}
            if method == "rs":
                gens.append(cauchy_a2a(sgrs, m, vals, procs, p, partial))
            else:
                Am = Ap[m * R : (m + 1) * R, :]
                gens.append(prepare_shoot(field, Am, vals, procs, p, partial))
        net.run(run_lockstep(*gens))

        # ---- phase 2: row-wise reduce into sink T_r -------------------
        out: dict[int, np.ndarray] = {}
        gens = []
        for r in range(R):
            row = [pos_proc(r, m) for m in range(M)]
            sink = K + r
            procs = ([sink] + row) if sink not in row else ([sink] + [q for q in row if q != sink])
            vals = {q: partial[q] for q in row}
            if sink not in vals:
                vals[sink] = np.zeros_like(x[0])
            gens.append(collectives.reduce(field, vals, procs, p, out))
        net.run(run_lockstep(*gens))
        result = np.stack([out[K + r] for r in range(R)])

    else:
        M = math.ceil(R / K)
        Ap = np.concatenate(
            [field.arr(A), np.zeros((K, M * K - R), np.int64)], axis=1
        )

        def pos_proc(k: int, m: int) -> int:
            """Grid K x M of sinks; borrowed source S_k pads unfilled rows."""
            r = k + m * K
            return K + r if r < R else k

        # ---- phase 1: row-wise broadcast of x_k -----------------------
        xk: dict[int, np.ndarray] = {}
        gens = []
        for k in range(K):
            row = [k] + [pos_proc(k, m) for m in range(M) if pos_proc(k, m) != k]
            gens.append(collectives.broadcast(field, x[k], row, p, xk))
        net.run(run_lockstep(*gens))

        # ---- phase 2: column-wise A2A on A'_m -------------------------
        out = {}
        gens = []
        for m in range(M):
            procs = [pos_proc(k, m) for k in range(K)]
            vals = {pos_proc(k, m): xk[pos_proc(k, m)] for k in range(K)}
            if method == "rs":
                gens.append(cauchy_a2a(sgrs, m, vals, procs, p, out))
            else:
                Am = Ap[:, m * K : (m + 1) * K]
                gens.append(prepare_shoot(field, Am, vals, procs, p, out))
        net.run(run_lockstep(*gens))
        result = np.stack([out[pos_proc(r % K, r // K)] for r in range(R)])

    return result, net


def nonsystematic_encode(
    field: Field,
    G: np.ndarray,
    x: np.ndarray,
    p: int = 1,
    net: RoundNetwork | None = None,
) -> tuple[np.ndarray, RoundNetwork]:
    """Appendix B: all N = K + R processors obtain x^T G[:, n] for a
    non-systematic generator G (K x N). Sinks start with 0 payloads."""
    G = field.arr(G)
    x = field.arr(x)
    K, N = G.shape
    R = N - K
    assert R >= 0
    net = net or RoundNetwork(N, p)

    if K > R:
        # pad G to N x N; sinks hold zero packets; one big A2A (App. B-A)
        Gp = np.concatenate([G, np.zeros((R, N), np.int64)])
        vals = {k: x[k] for k in range(K)}
        vals.update({K + r: np.zeros_like(x[0]) for r in range(R)})
        out: dict[int, np.ndarray] = {}
        net.run(prepare_shoot(field, Gp, vals, list(range(N)), p, out))
        return np.stack([out[i] for i in range(N)]), net

    # K <= R (App. B-B): grid of K-processor columns — column 0 = the sources
    # themselves, columns 1..M-1 = full sink columns, leftover L sinks are
    # distributed round-robin across the columns (stacked at the bottom,
    # holding zero packets, Fig. 9).
    full_sink_cols = R // K
    L = R % K
    M = 1 + full_sink_cols  # including the source column

    def col_members(m: int) -> list[int]:
        if m == 0:
            return list(range(K))  # sources
        return [K + (m - 1) * K + k for k in range(K)]

    leftovers = [K + full_sink_cols * K + l for l in range(L)]
    extras = {m: [t for i, t in enumerate(leftovers) if i % M == m] for m in range(M)}

    # ---- phase 1: row-wise broadcast of x_k to the sink columns ----------
    xk: dict[int, np.ndarray] = {}
    gens = []
    for k in range(K):
        row = [k] + [col_members(m)[k] for m in range(1, M)]
        gens.append(collectives.broadcast(field, x[k], row, p, xk))
    net.run(run_lockstep(*gens))

    # ---- phase 2: per-column A2A on square G'_m ---------------------------
    # main member k of column m outputs G column (m*K + k) ... wait: column 0
    # outputs G[:, 0:K] (the sources' own coded packets); sink column m >= 1
    # outputs G[:, m*K : (m+1)*K]; extra sink t outputs its own G column.
    out: dict[int, np.ndarray] = {}
    gens = []
    for m in range(M):
        members = col_members(m) + extras[m]
        n = len(members)
        out_cols = [m * K + k for k in range(K)] + [
            K + (t - K) for t in extras[m]
        ]
        sq = np.zeros((n, n), np.int64)
        sq[:K, :] = np.take(G, out_cols, axis=1)
        vals = {g: xk[g] for g in col_members(m)}
        for t in extras[m]:
            vals[t] = np.zeros_like(x[0])
        gens.append(prepare_shoot(field, sq, vals, members, p, out))
    net.run(run_lockstep(*gens))

    coded = np.zeros((N,) + np.asarray(x[0]).shape, np.int64)
    for m in range(M):
        for i, g in enumerate(col_members(m) + extras[m]):
            col = (m * K + i) if i < K else K + (extras[m][i - K] - K)
            coded[col] = out[g]
    return coded, net
