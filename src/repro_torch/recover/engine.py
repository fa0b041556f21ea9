"""All-to-all decode on the p-port round network (simulator backend body).

Erasure decode *dualizes* to the encode framework (Sec. III): once the
erasure pattern E is fixed, the lost symbols are a linear map of the K
chosen survivor symbols,

    y_E = D^T v        with  D = S^-1 G[:, E],  S = G[:, kept]  (K x K),

so the survivors can recompute them collectively with exactly the encode
machinery — sources are the K kept survivors (holding their codeword
symbols), "sinks" are the repaired positions, and the generator block is D.
Because D is a product with an inverse it carries no Vandermonde structure,
so the universal prepare-and-shoot schedule is the one that applies
(Sec. IV-B; the RS draw-and-loose factorization does not survive the
inversion).

Schedule (mirrors `core.framework.decentralized_encode`, case K >= R, with
the sinks *overlaid* on the survivors — no helper processors exist after a
failure, so nothing can be borrowed):

  * the |E| repair targets are processed in batches of at most K columns;
    a batch of width e is zero-padded to E' = the smallest divisor of K
    with E' >= e (zero columns ride along for free in prepare-and-shoot's
    C2 — message sizes depend only on the group size)
  * phase 1: the K kept survivors form an E' x M grid (M = K/E'); group m
    runs a square E' x E' prepare-and-shoot on its row block D'_m,
    leaving the partial sum for target j on its j-th member
  * phase 2: for each target j, a (p+1)-nomial reduce over the M group
    members onto kept[j] — the repaired symbol for erased position E[j]
    lands on the j-th kept survivor (rotating-parity style double duty).

Costs are closed-form (`decode_cost`, asserted against measured
`RoundNetwork` C1/C2 in tests): per batch, Thm. 3's universal A2A cost at
group size E' plus ceil(log_{p+1} M) reduce rounds.

The simulator backend now executes this schedule as a `core.schedule`
decode `RoundIR` (`schedule.build_decode_ir` transcribes the batched
grid above round-for-round); `decentralized_decode` remains the
paper-fidelity generator body and the shim for direct callers.
"""
from __future__ import annotations

import numpy as np

from ..core import collectives
from ..core.collectives import _n_rounds
from ..core.cost_model import LinearCost
from ..core.field import Field
from ..core.prepare_shoot import cost_universal_exact, prepare_shoot
from ..core.simulator import RoundNetwork, run_lockstep


def pad_width(K: int, e: int) -> int:
    """Smallest divisor of K that is >= e (the padded batch width E')."""
    assert 1 <= e <= K
    for d in range(e, K + 1):
        if K % d == 0:
            return d
    raise AssertionError("unreachable: K divides K")


def decode_batches(K: int, n_erased: int) -> list[tuple[int, int]]:
    """Column batches [(width, padded_width)] covering n_erased targets."""
    out = []
    left = n_erased
    while left > 0:
        e = min(left, K)
        out.append((e, pad_width(K, e)))
        left -= e
    return out


def batch_block(D: np.ndarray, b: int) -> np.ndarray:
    """Zero-padded (K, E') column block b of the repair matrix D.

    The single place the batching contract lives: both the simulator
    schedule and the mesh tables consume exactly these blocks."""
    K = D.shape[0]
    widths = decode_batches(K, D.shape[1])
    eb, ep = widths[b]
    col = sum(w for w, _ in widths[:b])
    blk = np.zeros((K, ep), np.int64)
    blk[:, :eb] = D[:, col : col + eb]
    return blk


def decode_cost(K: int, n_erased: int, p: int = 1) -> LinearCost:
    """Closed-form (C1, C2) of the all-to-all decode at W = 1.

    Per batch: one universal A2A at the padded group size E'
    (`cost_universal_exact` — the M = K/E' grid groups run in lockstep, so
    the parallel instances do not change the per-round maximum) plus
    ceil(log_{p+1} M) reduce rounds of one element each.  Exact: tests
    assert measured RoundNetwork counts equal this.
    """
    c1 = c2 = 0
    for _, ep in decode_batches(K, n_erased):
        u1, u2 = cost_universal_exact(ep, p)
        t = _n_rounds(K // ep, p)
        c1 += u1 + t
        c2 += u2 + t
    return LinearCost(c1, c2)


def decentralized_decode(
    field: Field,
    D: np.ndarray,
    v: np.ndarray,
    kept: list[int],
    p: int = 1,
    net: RoundNetwork | None = None,
) -> tuple[np.ndarray, RoundNetwork]:
    """Run the all-to-all decode; returns (repaired (|E|, W), network).

    D: (K, |E|) repair matrix; v: (K, W) survivor symbols ordered like
    `kept` (the global processor ids of the K chosen survivors — on a
    network with failures, none of them may be failed).
    """
    D = field.arr(D)
    v = field.arr(v)
    K, E = D.shape
    assert v.shape[0] == K == len(kept)
    net = net or RoundNetwork((max(kept) + 1) if kept else 1, p)

    rows: list[np.ndarray] = []
    for b, (eb, ep) in enumerate(decode_batches(K, E)):
        Db = batch_block(D, b)
        M = K // ep

        # ---- phase 1: M parallel square A2As on the row blocks D'_m -----
        partial: dict[int, np.ndarray] = {}
        gens = []
        for m in range(M):
            procs = [kept[m * ep + j] for j in range(ep)]
            vals = {procs[j]: v[m * ep + j] for j in range(ep)}
            gens.append(
                prepare_shoot(field, Db[m * ep : (m + 1) * ep, :], vals,
                              procs, p, partial))
        net.run(run_lockstep(*gens))

        # ---- phase 2: per-target reduce across the M groups -------------
        if M > 1:
            out: dict[int, np.ndarray] = {}
            gens = []
            for j in range(ep):
                procs = [kept[m * ep + j] for m in range(M)]  # root kept[j]
                vals = {q: partial[q] for q in procs}
                gens.append(collectives.reduce(field, vals, procs, p, out))
            net.run(run_lockstep(*gens))
        else:
            out = partial

        rows.extend(out[kept[j]] for j in range(eb))

    if not rows:
        return np.zeros((0,) + v.shape[1:], np.int64), net
    return np.stack(rows), net
