"""Universal all-to-all encode: the prepare-and-shoot algorithm (Sec. IV-B).

Computes (x_0..x_{K-1}) * C for ANY square matrix C over F_q with a fixed,
matrix-independent scheduling:

  * L = ceil(log_{p+1} K) rounds total (optimal C1, Lemma 1)
  * prepare phase (T_p = ceil(L/2) rounds): K parallel one-to-m broadcasts on
    (p+1)-nomial trees — after it, P_k holds x_r for r in R_k^- = [k-m+1, k]
  * shoot phase (T_s = floor(L/2) rounds): K parallel n-to-one reduces of the
    partially-encoded packets w_{k, k+l*m} = sum_{r in R_k^-} C[r, k+l*m] x_r
  * local overlap correction (eq. 4) when K < m*n.

NOTE on fidelity: the paper's Alg. 2 writes the round-t stride as `m^t`; the
correct stride — the dual of the prepare broadcast tree, validated here by
simulation against a direct matmul for every K <= 200 and p <= 4 — is
`m * (p+1)^(t-1)`.  See DESIGN.md §2.

State is a dict proc->np.ndarray (shape (W,) payload vectors; Remark 2: a
vector in F_q^W is an element of the extension field F_{q^W}, costing W times
C2 but the same C1).
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict

import numpy as np

from .field import Field
from .simulator import Msg


def phase_split(K: int, p: int) -> tuple[int, int, int, int]:
    """Return (L, T_p, T_s, m) per Sec. IV-B."""
    if K <= 1:
        return 0, 0, 0, 1
    L = math.ceil(math.log(K, p + 1))
    # guard float fuzz: smallest L with (p+1)^L >= K
    while (p + 1) ** L < K:
        L += 1
    while L > 1 and (p + 1) ** (L - 1) >= K:
        L -= 1
    T_p = (L + 1) // 2
    T_s = L // 2
    m = (p + 1) ** T_p
    return L, T_p, T_s, m


def prepare_shoot(
    field: Field,
    C: np.ndarray,
    x: dict[int, np.ndarray],
    procs: list[int],
    p: int,
    out: dict[int, np.ndarray],
):
    """Generator schedule computing x*C on the processor group `procs`.

    `procs[i]` is the global id of local processor i; `x[g]` the initial
    payload of global proc g (np int64, any shape, last axis = W); results are
    written to `out[g]`.  Yields one list[Msg] per communication round.
    """
    K = len(procs)
    C = field.arr(C)
    assert C.shape == (K, K)
    if K == 1:
        out[procs[0]] = field.mul(C[0, 0], x[procs[0]])
        return
        yield  # pragma: no cover

    L, T_p, T_s, m = phase_split(K, p)
    n = math.ceil(K / m)
    W = int(np.asarray(x[procs[0]]).size)

    # ---------------- prepare phase (Alg. 1) ------------------------------
    memory: list[dict[int, np.ndarray]] = [
        {k: field.arr(x[procs[k]])} for k in range(K)
    ]
    for t in range(1, T_p + 1):
        stride = (p + 1) ** (T_p - t)
        msgs: list[Msg] = []
        incoming: list[list[dict[int, np.ndarray]]] = [[] for _ in range(K)]
        for k in range(K):
            payload = dict(memory[k])  # entire memory content (Alg. 1 line 5)
            for rho in range(1, p + 1):
                dst = (k + rho * stride) % K
                if dst == k:
                    continue
                msgs.append(Msg(procs[k], procs[dst], len(payload) * W))
                incoming[dst].append(payload)
        yield msgs
        for k in range(K):
            for payload in incoming[k]:
                memory[k].update(payload)

    # each P_k now holds x_r for r in R_k^- = {k-l mod K : l in [0, m-1]}
    r_minus = [{(k - l) % K for l in range(min(m, K))} for k in range(K)]
    for k in range(K):
        assert set(memory[k]) == r_minus[k], "prepare phase coverage bug"

    # ---------------- shoot phase (Alg. 2, corrected stride) --------------
    # w[k][s]: partially coded packet for target s held at k
    w: list[dict[int, np.ndarray]] = [dict() for _ in range(K)]
    for k in range(K):
        for l in range(n):
            s = (k + l * m) % K
            acc = np.zeros(np.asarray(x[procs[k]]).shape, np.int64)
            for r in memory[k]:
                acc = field.add(acc, field.mul(C[r, s], memory[k][r]))
            w[k][s] = acc

    for t in range(1, T_s + 1):
        stride = m * (p + 1) ** (t - 1)  # paper's "m^t" corrected
        blk = (p + 1) ** t
        sub = (p + 1) ** (t - 1)
        grouped: dict[tuple[int, int], dict[int, np.ndarray]] = defaultdict(dict)
        for s in range(K):
            for j in range(n):
                rem = j % blk
                if rem == 0 or rem % sub != 0:
                    continue  # j not eliminated this round
                src = (s - j * m) % K
                dst = (s - (j - rem) * m) % K
                if s in w[src]:
                    grouped[(src, dst)][s] = w[src].pop(s)
        msgs = [
            Msg(procs[src], procs[dst], len(pl) * W)
            for (src, dst), pl in grouped.items()
        ]
        yield msgs
        for (src, dst), pl in grouped.items():
            for s, val in pl.items():
                w[dst][s] = field.add(w[dst][s], val)

    # ---------------- overlap correction (eq. 4) --------------------------
    for k in range(K):
        y = w[k][k]
        # multiplicity of each source index across the n sets R_{k-j*m}^-
        mult = Counter()
        for j in range(n):
            for r in r_minus[(k - j * m) % K]:
                mult[r] += 1
        corr = np.zeros_like(y)
        for r, c in mult.items():
            if c > 1:
                assert r in memory[k], "correction term not locally available"
                corr = field.add(corr, field.mul((c - 1) * C[r, k] % field.q, memory[k][r]))
        out[procs[k]] = field.sub(y, corr)


def universal_a2a(
    field: Field, C: np.ndarray, x: np.ndarray, p: int = 1, net=None
) -> np.ndarray:
    """Convenience wrapper: run prepare-and-shoot on K standalone processors.

    x: (K,) or (K, W) int64. Returns x*C with identical shape semantics.
    """
    from .simulator import RoundNetwork

    x = field.arr(x)
    K = C.shape[0]
    xs = {k: x[k] for k in range(K)}
    out: dict[int, np.ndarray] = {}
    net = net or RoundNetwork(K, p)
    net.run(prepare_shoot(field, C, xs, list(range(K)), p, out))
    return np.stack([out[k] for k in range(K)])


# ---------------- analytic costs (Thm. 3) ----------------------------------

def cost_universal(K: int, p: int) -> tuple[int, int]:
    """(C1, C2) of prepare-and-shoot for a K-processor group (W=1)."""
    if K <= 1:
        return 0, 0
    L, T_p, T_s, m = phase_split(K, p)
    c2_prep = ((p + 1) ** T_p - 1) // p
    c2_shoot = ((p + 1) ** T_s - 1) // p
    return L, c2_prep + c2_shoot


def cost_universal_exact(K: int, p: int) -> tuple[int, int]:
    """Exact measured (C1, C2) of `prepare_shoot`, round by round (W=1).

    Thm. 3 (`cost_universal`) counts the shoot phase at its worst case
    n = (p+1)^T_s targets per processor; when K is not a power of p+1 the
    actual n = ceil(K/m) is smaller, some shoot rounds carry fewer (or no)
    packets, and the simulator measures strictly less.  This closed form
    reproduces the schedule's counts exactly: shoot round t moves, from
    each sender, one packet per alive target index j with
    j mod (p+1)^t = rho*(p+1)^(t-1); a round with no such j never hits the
    network.  Used by the decode cost model, which is asserted *equal* to
    the measured RoundNetwork counts.
    """
    if K <= 1:
        return 0, 0
    L, T_p, T_s, m = phase_split(K, p)
    n = math.ceil(K / m)
    c1 = T_p
    c2 = ((p + 1) ** T_p - 1) // p
    for t in range(1, T_s + 1):
        blk = (p + 1) ** t
        sub = (p + 1) ** (t - 1)
        m_t = max(
            sum(1 for j in range(n) if j % blk == rho * sub)
            for rho in range(1, p + 1))
        if m_t:
            c1 += 1
            c2 += m_t
    return c1, c2
