"""CodeSpec: the *what* of a decentralized encode, decoupled from the *how*.

A spec pins down the code family, system shape and communication model:

    kind : "universal"  — any generator block A (K x R); A is either derived
                          deterministically from `seed` or passed explicitly
                          to `Encoder.plan(..., A=...)`
           "rs"         — systematic Reed-Solomon [I | A] from a
                          StructuredGRS construction (Sec. VI)
           "lagrange"   — the u = v = 1 GRS case (Remark 9); with an explicit
                          A, arbitrary interpolation points are allowed
           "dft"        — the K x K permuted-DFT transform (Sec. V-A); R == K
    K, R : sources / sinks (paper's N = K + R)
    p    : ports per processor per round
    W    : payload width in field elements (cost modeling only — `.run`
           accepts any width; host tables never depend on W)
    q    : field modulus (Fermat prime 65537 by default — the only modulus
           the local backend's CUDA kernels support)
    P    : radix of the structured-points / DFT factorizations

Specs are frozen and hashable: they are the cache key for host-side tables
and plans (see `repro_torch.api.planner`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..core.field import FERMAT, FERMAT_Q, Field

KINDS = ("universal", "rs", "lagrange", "dft")


@dataclass(frozen=True)
class CodeSpec:
    kind: str
    K: int
    R: int
    p: int = 1
    W: int = 1
    q: int = FERMAT_Q
    P: int = 2
    seed: int | None = None  # kind="universal": deterministic random A

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; expected one of {KINDS}")
        if self.K < 1 or self.R < 1:
            raise ValueError("K and R must be >= 1")
        if self.p < 1:
            raise ValueError("p >= 1 ports required")
        if self.W < 1:
            raise ValueError("W >= 1 required")
        if self.kind == "dft":
            if self.R != self.K:
                raise ValueError("dft is a K x K transform: set R == K")
            Z = 1
            while Z < self.K:
                Z *= self.P
            if Z != self.K:
                raise ValueError(f"dft needs K a power of P={self.P}")
            if (self.q - 1) % self.K != 0:
                raise ValueError("dft needs K | q-1")

    @property
    def field(self) -> Field:
        return FERMAT if self.q == FERMAT_Q else Field(self.q)

    @property
    def N(self) -> int:
        """Total processors in the paper's system model."""
        return self.K + self.R

    def table_key(self) -> tuple:
        """Cache key for host-side tables: everything except the payload
        width W (tables and schedules are W-independent, Remark 2)."""
        return (self.kind, self.K, self.R, self.p, self.q, self.P, self.seed)

    def with_W(self, W: int) -> "CodeSpec":
        return replace(self, W=W)

    def structured(self) -> bool:
        """Whether the spec's matrix comes from a structured construction
        (enabling the RS/Lagrange-specific all-to-all schedules)."""
        return self.kind in ("rs", "lagrange")

    def default_matrix(self, field: Field | None = None) -> np.ndarray:
        """The (K, R) generator block implied by the spec alone (no explicit
        A): structured GRS / Lagrange A, permuted-DFT matrix, or the
        seed-derived uniform random block for kind="universal"."""
        field = field or self.field
        if self.kind == "dft":
            from ..core.matrices import permuted_dft_matrix

            return permuted_dft_matrix(field, self.K, self.P)
        if self.structured():
            from ..core.cauchy import StructuredGRS

            sgrs = StructuredGRS.build(field, self.K, self.R, P=self.P,
                                       lagrange=self.kind == "lagrange")
            return sgrs.grs.A_direct()
        if self.seed is None:
            raise ValueError(
                "kind='universal' needs either spec.seed or an explicit A "
                "passed to Encoder.plan(..., A=...)")
        return field.rand((self.K, self.R), np.random.default_rng(self.seed))
