"""(p+1)-nomial tree one-to-all broadcast and all-to-one reduce (Defs. 2-3,
Appendix A).  Cost: C_BR(N, W) = ceil(log_{p+1} N) rounds of W-element
messages.  Reduce is the dual of broadcast (reversed communication order).
"""
from __future__ import annotations

import math

import numpy as np

from .field import Field
from .simulator import Msg


def _n_rounds(N: int, p: int) -> int:
    if N <= 1:
        return 0
    T = math.ceil(math.log(N, p + 1))
    while (p + 1) ** T < N:
        T += 1
    while T > 1 and (p + 1) ** (T - 1) >= N:
        T -= 1
    return T


def broadcast(
    field: Field,
    value: np.ndarray,
    procs: list[int],
    p: int,
    out: dict[int, np.ndarray],
):
    """Root procs[0] disseminates `value` to every processor in `procs`."""
    N = len(procs)
    W = int(np.asarray(value).size)
    T = _n_rounds(N, p)
    have = {0}
    for t in range(1, T + 1):
        stride = (p + 1) ** (T - t)
        msgs, new = [], set()
        for i in sorted(have):
            for rho in range(1, p + 1):
                j = i + rho * stride
                if j < N and j not in have and j not in new:
                    msgs.append(Msg(procs[i], procs[j], W))
                    new.add(j)
        yield msgs
        have |= new
    assert have == set(range(N))
    for i in range(N):
        out[procs[i]] = field.arr(value)


def reduce(
    field: Field,
    values: dict[int, np.ndarray],
    procs: list[int],
    p: int,
    out: dict[int, np.ndarray],
):
    """All-to-one sum-reduce onto root procs[0] (dual of broadcast)."""
    N = len(procs)
    acc = {i: field.arr(values[procs[i]]) for i in range(N)}
    W = int(np.asarray(acc[0]).size)
    T = _n_rounds(N, p)
    # replay broadcast rounds in reverse: receivers become senders
    plan: list[list[tuple[int, int]]] = []
    have = {0}
    for t in range(1, T + 1):
        stride = (p + 1) ** (T - t)
        edges, new = [], set()
        for i in sorted(have):
            for rho in range(1, p + 1):
                j = i + rho * stride
                if j < N and j not in have and j not in new:
                    edges.append((i, j))
                    new.add(j)
        plan.append(edges)
        have |= new
    for edges in reversed(plan):
        msgs = [Msg(procs[j], procs[i], W) for (i, j) in edges]
        yield msgs
        for (i, j) in edges:
            acc[i] = field.add(acc[i], acc[j])
    out[procs[0]] = acc[0]


def cost_broadcast(N: int, p: int, W: int = 1) -> tuple[int, int]:
    T = _n_rounds(N, p)
    return T, T * W
