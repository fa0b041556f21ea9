"""Lagrange coded computing (Remark 9 / Yu et al. [9]) over F_65537.

Masterless LCC: K data shards x_0..x_{K-1} in F_q^W are interpolated into a
polynomial g with g(alpha_k) = x_k; each of N workers holds the coded shard
x~_n = g(beta_n) — produced decentralized via the paper's Cauchy-like
all-to-all encode (the Lagrange matrix V_alpha^-1 V_beta, Remark 9).
Workers apply a polynomial f of degree d elementwise; the results
f(g(beta_n)) are evaluations of h = f o g (degree d*(K-1)), so ANY
d*(K-1)+1 worker results reconstruct every f(x_k) — stragglers and even
Byzantine-silent workers are tolerated by construction.

Decoding is an erasure decode, not a bespoke solve: h is a degree-(T-1)
polynomial (T = d*(K-1)+1), so its evaluations over alphas ∪ betas form a
length-(K+N) MDS code with T data symbols.  The alphas (and any dead
betas) are the erasures; `Decoder.plan` repairs them through the same
cached decode-plan path — and the same drift/metrics instrumentation — the
storage stack uses.  Non-Fermat fields fall back to the host interpolation
loop (the CUDA kernels are Fermat-only).  Encode and decode run on the
computer's `device` (None means "cuda"; moot on the simulator).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..api import CodedSystem, CodeSpec, EncodePlan
from ..core.field import Field
from ..core.matrices import lagrange_matrix
from .gradient_code import FERMAT_Q, default_backend


@dataclass(frozen=True)
class LagrangeComputer:
    field: Field
    alphas: np.ndarray  # (K,)
    betas: np.ndarray   # (N,)
    device: Any = None  # torch device of every session and decode plan

    @property
    def K(self):
        return self.alphas.size

    @property
    def N(self):
        return self.betas.size

    @staticmethod
    def build(field: Field, K: int, N: int, *,
              device=None) -> "LagrangeComputer":
        pts = np.arange(1, K + N + 1, dtype=np.int64)
        return LagrangeComputer(field, pts[:K], pts[K:], device)

    def system(self, *, backend: str | None = None) -> CodedSystem:
        """The `CodedSystem` session for this computer's Lagrange matrix.

        Arbitrary (unstructured) interpolation points, so the planner
        schedules the universal algorithm; the session (and its Lagrange
        matrix) is memoized here and in the shared plan caches across
        encodes.  Default backend: `default_backend(q)` — the local kernels
        for F_65537, the exact simulator for other fields."""
        if backend is None:
            backend = default_backend(self.field.q)
        cached = self.__dict__.get(f"_system_{backend}")
        if cached is None:
            L = lagrange_matrix(self.field, self.alphas, self.betas)
            spec = CodeSpec(kind="lagrange", K=self.K, R=self.N, q=self.field.q)
            cached = CodedSystem(spec, backend=backend, A=L,
                                 device=self.device)
            object.__setattr__(self, f"_system_{backend}", cached)
        return cached

    def encode_plan(self, *, backend: str | None = None) -> EncodePlan:
        """The planner-layer `EncodePlan` behind `system(backend=...)`."""
        return self.system(backend=backend).encode_plan

    def encode(self, x: np.ndarray) -> np.ndarray:
        """x: (K, W) -> coded (N, W) = L^T x, L = V_alpha^-1 V_beta.

        Executes via `CodedSystem.encode` on the local kernel backend."""
        return self.system().encode(x)

    def recovery_threshold(self, deg: int) -> int:
        return deg * (self.K - 1) + 1

    def _decode_spec(self, deg: int) -> tuple[CodeSpec, np.ndarray]:
        """The virtual erasure code behind a degree-`deg` decode.

        h = f∘g has degree ≤ T-1 (T the recovery threshold), so its
        evaluations at nodes = alphas ∪ betas are a (K+N, T) MDS code:
        any T nodes are data, the rest parity.  Memoized per deg — the
        parity matrix costs an interpolation to build but every repeat
        decode (and every straggler pattern) then shares `Decoder.plan`'s
        LRU cache."""
        key = f"_decode_spec_{deg}"
        cached = self.__dict__.get(key)
        if cached is None:
            T = self.recovery_threshold(deg)
            nodes = np.concatenate([self.field.arr(self.alphas),
                                    self.field.arr(self.betas)])
            if T >= nodes.size:
                raise ValueError(
                    f"degree {deg} needs T={T} of N={self.N} workers — "
                    "no redundancy left to decode around")
            A = lagrange_matrix(self.field, nodes[:T], nodes[T:])
            spec = CodeSpec(kind="lagrange", K=T, R=nodes.size - T,
                            q=self.field.q)
            cached = (spec, A)
            object.__setattr__(self, key, cached)
        return cached

    def decode(self, deg: int, worker_ids: np.ndarray,
               results: np.ndarray) -> np.ndarray:
        """Interpolate h from >= deg*(K-1)+1 worker results, return f(x_k).

        worker_ids: indices into `betas` of the workers that returned;
        `results[i]` is worker `worker_ids[i]`'s f(x~) evaluation.  Routed
        through `Decoder.plan` (the cached decode-plan path shared with the
        storage stack): the alphas and the dead betas are erasures of the
        virtual code from `_decode_spec`, and the repaired alpha symbols
        are exactly f(x_k).  Falls back to `_decode_host` for non-Fermat q.
        """
        f = self.field
        T = self.recovery_threshold(deg)
        worker_ids = np.asarray(worker_ids, dtype=np.int64)
        assert worker_ids.size >= T, "not enough workers returned"
        if f.q != FERMAT_Q:
            return self._decode_host(deg, worker_ids, results)

        from ..recover.planner import Decoder

        spec, A = self._decode_spec(deg)
        live = set(int(w) for w in worker_ids)
        # node positions: alphas at 0..K-1, beta_b at K+b
        erased = tuple(range(self.K)) + tuple(
            self.K + b for b in range(self.N) if b not in live)
        plan = Decoder.plan(spec, erased, backend=default_backend(f.q), A=A,
                            device=self.device)

        vals = f.arr(results)
        row_of = {int(w): i for i, w in enumerate(worker_ids)}
        v = np.stack([vals[row_of[pos - self.K]] for pos in plan.kept])
        tail = v.shape[1:]
        repaired = plan.run(v.reshape(T, -1) if tail else v)
        # plan.erased is sorted and contains every alpha position, so the
        # first K repaired rows are h(alpha_k) = f(x_k)
        out = repaired[:self.K]
        return out.reshape((self.K,) + tail) if tail else out

    def _decode_host(self, deg: int, worker_ids: np.ndarray,
                     results: np.ndarray) -> np.ndarray:
        """Host Lagrange interpolation of h at the alphas — the exact
        fallback for fields the kernel backends don't support."""
        f = self.field
        T = self.recovery_threshold(deg)
        pts = self.betas[worker_ids[:T]]
        vals = f.arr(results[:T])
        out = np.zeros((self.K,) + vals.shape[1:], np.int64)
        for j, a in enumerate(self.alphas):
            acc = np.zeros(vals.shape[1:], np.int64)
            for i in range(T):
                num, den = np.int64(1), np.int64(1)
                for t in range(T):
                    if t == i:
                        continue
                    num = f.mul(num, f.sub(a, pts[t]))
                    den = f.mul(den, f.sub(pts[i], pts[t]))
                acc = f.add(acc, f.mul(vals[i], f.mul(num, f.inv(den))))
            out[j] = acc
        return out
