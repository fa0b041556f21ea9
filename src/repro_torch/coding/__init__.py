"""Coded computation on top of the session/planner stack — ONE surface.

Every entry point here is a thin, memoized front onto `repro_torch.api`
(`CodedSystem` sessions, shared plan caches, drift/metrics hooks); the
signatures are the JAX package's plus `device=` (None means "cuda"; moot
on the host-only simulator).  `system()` takes keyword-only
`backend=`/`q=` with the shared default (`default_backend(q)`: the local
CUDA kernels for F_65537, the simulator otherwise).

    GradientCoder(n_workers, s)       — Tandon-style gradient coding
        .combine(worker_grads, alive) — exact full-batch gradient around
                                        ≤ s stragglers (bitwise in float)
        .decode_weights(alive)        — the 0/1 recovery vector (a @ B = 1)
        .system(*, backend=, q=, device=) — field-quantized encode session

    LagrangeComputer.build(field, K, N, device=) — Lagrange coded computing
        .encode(x)                    — (K, W) -> (N, W) coded shards
        .decode(deg, ids, results)    — any deg*(K-1)+1 results -> f(x_k),
                                        via the cached decode-plan path
        .system(*, backend=)          — the session behind encode/decode

    CodedMatmul(K, R, backend=, q=, device=) — dropout-tolerant coded
        cm(X, W, dead=...)            inference: Y = X @ W exactly, ≤ R
                                      dropouts

    coded_gradient(coder, grads, alive) — deprecated; GradientCoder.combine
"""
from .coded_matmul import CodedMatmul
from .gradient_code import (FERMAT_Q, GradientCoder, coded_gradient,
                            default_backend)
from .lagrange_compute import LagrangeComputer

__all__ = ["GradientCoder", "LagrangeComputer", "CodedMatmul",
           "coded_gradient", "default_backend", "FERMAT_Q"]
