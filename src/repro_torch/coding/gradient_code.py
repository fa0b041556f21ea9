"""Gradient coding for straggler mitigation (Tandon et al., adapted).

Fractional-repetition scheme: n workers, tolerance s with (s+1) | n.
The global batch is cut into n parts; workers are organized into n/(s+1)
groups of (s+1); every worker in group g computes the gradients of *all*
(s+1) parts owned by g and reports their sum.  Any n - s workers contain at
least one member of every group (s stragglers cannot empty a group of
s+1), so the decoder sums one representative per group to recover the exact
full-batch gradient — no approximation, deterministic latency bound.

`combine` maps over trees of torch tensors (or numpy arrays) in the JAX
package's leaf order (`core.pytree`): it sums the representatives in
worker order, then divides by n, so a float32 result is bitwise the JAX
package's.  The straggler-tolerant train step (`repro/train/coded_step.py`)
comes with the port's training substrate.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np

from ..core.pytree import tree_map

FERMAT_Q = 65537


def default_backend(q: int) -> str:
    """The coding layer's shared backend default: the local CUDA kernels
    for the Fermat prime, the exact simulator for every other field (the
    kernels are Fermat-only)."""
    return "local" if q == FERMAT_Q else "simulator"


@dataclass(frozen=True)
class GradientCoder:
    n_workers: int
    s: int  # stragglers tolerated

    def __post_init__(self):
        assert self.n_workers % (self.s + 1) == 0, "(s+1) | n required"

    @property
    def n_groups(self) -> int:
        return self.n_workers // (self.s + 1)

    def parts_for_worker(self, w: int) -> list[int]:
        g = w // (self.s + 1)
        return [g * (self.s + 1) + i for i in range(self.s + 1)]

    def encode_matrix(self) -> np.ndarray:
        """B[w, part] = 1 if worker w computes that part."""
        B = np.zeros((self.n_workers, self.n_workers))
        for w in range(self.n_workers):
            B[w, self.parts_for_worker(w)] = 1.0
        return B

    def system(self, *, backend: str | None = None, q: int = FERMAT_Q,
               device=None):
        """`CodedSystem` session for the fractional-repetition encode.

        `system.encode(parts)` computes worker reports B @ parts over F_q —
        the field-quantized path for running gradient-code group sums
        through the decentralized encoder (sink r = worker r's report, so
        the session matrix is B^T).  Float training keeps using `combine`.

        The session is memoized per (backend, q) and device — repeated
        calls reuse one `CodedSystem` (and its planner-cache entries)
        instead of leaking a fresh session per call.  Default backend:
        `default_backend(q)`; `device` None means "cuda" (moot on the
        host-only simulator).
        """
        from ..api import CodedSystem, CodeSpec
        from ..api.registry import plan_device

        if backend is None:
            backend = default_backend(q)
        dev = plan_device(backend, device)
        key = f"_system_{backend}_{q}_{dev}"
        cached = self.__dict__.get(key)
        if cached is None:
            spec = CodeSpec(kind="universal", K=self.n_workers,
                            R=self.n_workers, q=q)
            cached = CodedSystem(spec, backend=backend,
                                 A=self.encode_matrix().T.astype(np.int64),
                                 device=dev)
            object.__setattr__(self, key, cached)
        return cached

    def encode_plan(self, *, backend: str | None = None, q: int = FERMAT_Q,
                    device=None):
        """The planner-layer `EncodePlan` behind `system(...)`."""
        return self.system(backend=backend, q=q, device=device).encode_plan

    def decode_weights(self, alive: np.ndarray) -> np.ndarray:
        """alive: (n,) bool. Returns a (n,) weight vector a with
        a @ B == ones (full-batch recovery), a_w = 0 for stragglers."""
        a = np.zeros(self.n_workers)
        for g in range(self.n_groups):
            members = [g * (self.s + 1) + i for i in range(self.s + 1)]
            live = [w for w in members if alive[w]]
            if not live:
                raise RuntimeError(f"group {g} fully straggled (> s failures)")
            a[live[0]] = 1.0
        return a

    def combine(self, worker_grads: list, alive: np.ndarray):
        """Combine per-worker (already group-summed) gradient trees into
        the exact full-batch gradient; any ≤ s stragglers are decoded
        around via `decode_weights` (>s per group raises loudly).

        Selection is by the 0/1 weight vector on the host, so the
        surviving terms enter the sum unscaled — recovery is bitwise-exact
        in float, not just allclose."""
        a = self.decode_weights(np.asarray(alive))
        total = None
        for w, g in enumerate(worker_grads):
            if a[w] == 0 or g is None:
                continue
            total = g if total is None else tree_map(lambda x, y: x + y,
                                                     total, g)
        return tree_map(lambda x: x / self.n_workers, total)


def coded_gradient(coder: GradientCoder, worker_grads: list, alive: np.ndarray):
    """Deprecated shim — use `GradientCoder.combine(worker_grads, alive)`."""
    warnings.warn(
        "coded_gradient() is deprecated; use "
        "GradientCoder.combine(worker_grads, alive)",
        DeprecationWarning, stacklevel=2)
    return coder.combine(worker_grads, alive)
