"""Analytic communication-cost model (Table I + Sec. III theorems) and
literature baselines for comparison.

All costs are (C1, C2) pairs in (rounds, field elements); the scalar cost is
C = alpha*C1 + beta*ceil(log2 q)*C2*W for W-element payload vectors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .collectives import cost_broadcast
from .dft_a2a import cost_dft
from .draw_loose import cost_draw_loose
from .prepare_shoot import cost_universal


@dataclass(frozen=True)
class LinearCost:
    """C = alpha*C1 + beta_bits*C2 (beta_bits = beta * ceil(log2 q))."""

    C1: int
    C2: int

    def total(self, alpha: float, beta_bits: float, W: int = 1) -> float:
        return alpha * self.C1 + beta_bits * self.C2 * W

    def __add__(self, other: "LinearCost") -> "LinearCost":
        return LinearCost(self.C1 + other.C1, self.C2 + other.C2)


def universal(K: int, p: int) -> LinearCost:
    return LinearCost(*cost_universal(K, p))


def dft(K: int, P: int, p: int) -> LinearCost:
    return LinearCost(*cost_dft(K, P, p))


def vandermonde(sp, p: int) -> LinearCost:
    return LinearCost(*cost_draw_loose(sp, p))


def broadcast(N: int, p: int, W: int = 1) -> LinearCost:
    return LinearCost(*cost_broadcast(N, p, W))


def framework(K: int, R: int, p: int, a2a: LinearCost, W: int = 1) -> LinearCost:
    """Thm. 1 / Thm. 2: phase-one A2A (parallel, max over blocks) + phase-two
    broadcast-or-reduce over the ceil(max/min) grid dimension."""
    M = math.ceil(max(K, R) / min(K, R))
    br = broadcast(M + 1, p, W)
    return LinearCost(a2a.C1 + br.C1, a2a.C2 * W + br.C2)


# ---------------------------------------------------------------------------
# Baselines from the literature (Sec. II)
# ---------------------------------------------------------------------------

def gather_encode_scatter(K: int, R: int, p: int, W: int = 1) -> LinearCost:
    """Centralized strawman: gather all K payloads at one processor
    ((p+1)-nomial gather: log rounds, ~K/p elements through the root's
    ports), encode locally, then send each of R sinks its packet."""
    t_gather = math.ceil(math.log(K, p + 1)) if K > 1 else 0
    c2_gather = math.ceil((K - 1) / p) * W
    t_scatter = math.ceil(R / p)
    c2_scatter = math.ceil(R / p) * W
    return LinearCost(t_gather + t_scatter, c2_gather + c2_scatter)


def multireduce_jeong(K: int, R: int, p: int, W: int = 1) -> LinearCost:
    """Multi-reduce of Jeong et al. [21] (one-port, R | K): per Sec. II it
    incurs (R - 2*sqrt(R) - 1) * beta*log2(q)*W more traffic than our
    framework-with-universal-A2A solution; C1 comparable."""
    assert p == 1, "multi-reduce is defined for the one-port model"
    ours = framework(K, R, p, universal(min(K, R), p), W)
    extra = max(0.0, (R - 2 * math.sqrt(R) - 1)) * W
    return LinearCost(ours.C1, int(round(ours.C2 + extra)))


def lower_bound_c2(K: int, p: int) -> float:
    """Lemma 2: C2 >= sqrt(2K)/p - O(1) for any universal algorithm."""
    return math.sqrt(2 * K) / p - (1 - 1 / p + 0.5)


def lower_bound_c1(K: int, p: int) -> int:
    """Lemma 1: C1 >= ceil(log_{p+1} K)."""
    return math.ceil(math.log(K, p + 1)) if K > 1 else 0


def summary_table(K: int, p: int) -> dict[str, tuple[int, int]]:
    """Table I for a given K (when the specific algorithms apply)."""
    from .matrices import StructuredPoints
    from .field import FERMAT

    out = {"universal": cost_universal(K, p)}
    if K & (K - 1) == 0:  # power of two: DFT applies over F_65537
        out["dft(P=2)"] = cost_dft(K, 2, p)
    try:
        sp = StructuredPoints.build(FERMAT, K, P=2)
        out["vandermonde"] = cost_draw_loose(sp, p)
    except ValueError:
        pass
    return out
