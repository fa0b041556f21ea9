"""Dropout-tolerant coded inference: Y = X @ W over F_q, Lagrange-coded.

A matmul is degree-1 in the data, so encode and compute commute: if the K
row-shards of X are Lagrange-encoded into K+R worker shards (systematic,
via `CodedSystem.codeword`), then each worker's local `shard @ W` is the
SAME codeword position of Y — the results of any K live workers decode to
the exact Y through the existing `recover/` stack (`CodedSystem.read`),
bitwise, for any ≤ R dropouts.  This is the serving-side counterpart of
gradient coding: a replicated layer's matmuls keep their answers while
workers die, with no recomputation.

The session is a plain `CodedSystem` on `device` (None means "cuda"), so
every backend (simulator oracle, the local CUDA kernels) and every
instrumentation hook (decode-plan cache, drift ledger, obs metrics)
applies unchanged: `encode` runs the parity on the card and `decode` the
repair.  `worker_compute` stays the exact numpy `field.matmul`: it stands
in for the workers, not for the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..api import CodedSystem, CodeSpec
from ..core.field import Field
from .gradient_code import FERMAT_Q, default_backend


@dataclass
class CodedMatmul:
    """K data shards, R parity workers, N = K + R total.

    `X` is (K*b, d): b rows per shard.  Workers hold (b, d) shards; each
    computes its `shard @ W (mod q)`; `decode` recovers Y = X @ W exactly
    from any K live results.  `device` is the session's torch device
    (None means "cuda"; moot on the simulator).
    """

    K: int
    R: int
    backend: str | None = None
    q: int = FERMAT_Q
    device: Any = None
    system: CodedSystem = dc_field(init=False, repr=False)

    def __post_init__(self):
        if self.backend is None:
            self.backend = default_backend(self.q)
        spec = CodeSpec(kind="lagrange", K=self.K, R=self.R, q=self.q)
        self.system = CodedSystem(spec, backend=self.backend,
                                  device=self.device)

    @property
    def field(self) -> Field:
        return self.system.spec.field

    @property
    def N(self) -> int:
        return self.K + self.R

    def encode(self, X: np.ndarray) -> np.ndarray:
        """X: (K*b, d) -> (N, b, d) worker shards: data shards 0..K-1
        verbatim (systematic), parity shards via the session encode."""
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[0] % self.K:
            raise ValueError(f"X must be (K*b, d) with K={self.K}, "
                             f"got {X.shape}")
        b = X.shape[0] // self.K
        flat = X.reshape(self.K, b * X.shape[1])
        cw = self.system.codeword(flat)  # (N, b*d)
        return cw.reshape(self.N, b, X.shape[1])

    def worker_compute(self, shards: np.ndarray, W: np.ndarray,
                       workers=None) -> np.ndarray:
        """Each (live) worker's local product: shards[n] @ W mod q."""
        workers = range(self.N) if workers is None else workers
        return np.stack([self.field.matmul(shards[n], W) for n in workers])

    def decode(self, results: np.ndarray, dead=()) -> np.ndarray:
        """results: (N, b, out) per-worker products (rows of dead workers
        ignored) -> Y = X @ W mod q, (K*b, out), decoding around the dead
        set via the session's erasure-aware `read`."""
        dead = sorted(int(d) for d in dead)
        if len(dead) > self.R:
            raise ValueError(f"{len(dead)} dropouts exceed R={self.R}")
        n, b, out = results.shape
        flat = np.ascontiguousarray(results).reshape(n, b * out)
        self.system.fail(dead)
        try:
            Y = self.system.read(flat)  # (K, b*out), repaired
        finally:
            self.system.heal(dead)
        return Y.reshape(self.K * b, out)

    def __call__(self, X: np.ndarray, W: np.ndarray, dead=()) -> np.ndarray:
        """End-to-end coded matmul: encode, drop `dead` workers' results,
        decode.  Bitwise-equal to `field.matmul(X, W)` for ≤ R dropouts."""
        shards = self.encode(X)
        results = self.worker_compute(shards, self.field.arr(W))
        return self.decode(results, dead)

    def close(self) -> None:
        self.system.close()

    def __enter__(self) -> "CodedMatmul":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
