"""Decoder: the decode/repair planner, mirroring `repro_torch.api.Encoder`.

    spec = CodeSpec(kind="rs", K=16, R=4)
    plan = Decoder.plan(spec, erased=(2, 17), backend="local")
    lost = plan.run(v)        # v: (K, W) symbols at plan.kept -> (|E|, W)
    x    = plan.data(v)       # full original data (K, W)

The systematic codeword of a spec is [x | EncodePlan.run(x)] — data symbol
k lives on processor k, parity symbol r on processor K + r.  `erased` is a
set of codeword positions in [0, K + R); `plan.run` recomputes exactly the
erased symbols from the K survivors `plan.kept` (chosen greedily as the
first survivor positions whose generator columns are linearly independent
— for MDS kinds that is simply the first K survivors; the DFT transform's
[I | A] is *not* MDS, and a pattern whose survivors span less than the
full message space raises `UndecodableError`).

Like the encoder, everything host-side happens once at plan time and is
cached: the survivor submatrix inverse S^-1 and the repair matrix
D = S^-1 G[:, E] (numpy, exact), and per plan their copies on the device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..api.backends import run_on_device
from ..api.planner import ALPHA_DEFAULT, BETA_BITS_DEFAULT, _digest, _host_tables
from ..api.registry import PlanStats, get_backend, resolve_device
from ..api.spec import CodeSpec
from ..core.cost_model import LinearCost
from ..core.field import FERMAT_Q, Field
from ..core.matrices import gauss_inverse
from .engine import decode_cost


class UndecodableError(ValueError):
    """The erasure pattern is information-losing: a nonzero codeword is
    supported entirely on the erased positions (only possible for non-MDS
    kinds, e.g. the DFT transform's [I | A] codeword)."""


def _choose_kept(field: Field, G: np.ndarray, survivors: list[int], K: int) -> tuple[int, ...]:
    """First K survivor positions with linearly independent generator
    columns (greedy Gaussian elimination over F_q)."""
    basis: list[tuple[int, np.ndarray]] = []  # (pivot row, normalized col)
    kept: list[int] = []
    for s in survivors:
        vec = G[:, s] % field.q
        for piv, r in basis:
            if vec[piv]:
                vec = (vec - vec[piv] * r) % field.q
        nz = np.nonzero(vec)[0]
        if nz.size == 0:
            continue
        piv = int(nz[0])
        basis.append((piv, (vec * int(field.inv(vec[piv]))) % field.q))
        kept.append(s)
        if len(kept) == K:
            return tuple(kept)
    raise UndecodableError(
        f"survivors span a {len(kept)}-dimensional space < K={K}: the "
        "erasure pattern is undecodable for this (non-MDS) code")


# ---------------------------------------------------------------------------
# host-side decode tables (cached per spec x erasure pattern, W-independent)
# ---------------------------------------------------------------------------

@dataclass
class DecodeTables:
    """Everything host-side a decode plan needs, built once per
    (spec, erased) and shared across backends, devices and payload widths."""

    spec: CodeSpec
    field: Field
    erased: tuple[int, ...]      # sorted codeword positions, |E| <= R
    kept: tuple[int, ...]        # the K chosen survivor positions
    D: np.ndarray                # (K, |E|) repair matrix  S^-1 G[:, E]
    Dd: np.ndarray               # (K, K)  data matrix     S^-1


# Unlike the encoder's caches (keyed by a handful of specs), decode keys
# range over erasure *patterns* — a combinatorial space on a long-running
# server that decodes around ever-changing failure sets — so both caches
# are LRU-bounded instead of unbounded dicts.
_DTABLES: "OrderedDict[tuple, DecodeTables]" = OrderedDict()
_DPLANS: "OrderedDict[tuple, DecodePlan]" = OrderedDict()
_DTABLES_MAX = 256
_DPLANS_MAX = 512
_DSTATS = {"table_hits": 0, "table_misses": 0,
           "plan_hits": 0, "plan_misses": 0}


def _lru_get(cache: OrderedDict, key):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache: OrderedDict, key, value, maxsize: int) -> None:
    cache[key] = value
    while len(cache) > maxsize:
        cache.popitem(last=False)


def _decode_tables(spec: CodeSpec, erased: tuple[int, ...],
                   A: np.ndarray | None, digest: str | None) -> DecodeTables:
    key = spec.table_key() + (digest, erased)
    hit = _lru_get(_DTABLES, key)
    if hit is not None:
        _DSTATS["table_hits"] += 1
        return hit
    _DSTATS["table_misses"] += 1
    host = _host_tables(spec, A, digest)   # shares the Encoder's table cache
    f = host.field
    K = spec.K
    G = np.concatenate([np.eye(K, dtype=np.int64), host.A % f.q], axis=1)
    survivors = [i for i in range(spec.N) if i not in set(erased)]
    kept = _choose_kept(f, G, survivors, K)
    sub = G[:, list(kept)]
    inv_sub = gauss_inverse(f, sub)
    D = f.matmul(inv_sub, G[:, list(erased)])
    tables = DecodeTables(spec, f, erased, kept, D, inv_sub)
    _lru_put(_DTABLES, key, tables, _DTABLES_MAX)
    return tables


# ---------------------------------------------------------------------------
# DecodePlan
# ---------------------------------------------------------------------------

@dataclass
class DecodePlan(PlanStats):
    """An executable erasure decode: spec + erasure pattern + backend +
    cached host tables + the device it runs on.  Obtained from
    `Decoder.plan`; cached — hold on to it and call `.run` per payload."""

    op = "decode"  # backend dispatch discriminator (not a field)

    spec: CodeSpec
    backend: str
    tables: DecodeTables
    device: Any = None           # torch.device the kernels run on
    _local_fn: Any = None
    _Dd: Any = None              # lazy device copy of tables.Dd (int32)
    # thread-local per-run stats storage (PlanStats reads/writes this)
    _tls: Any = dc_field(default_factory=threading.local, repr=False)

    @property
    def field(self) -> Field:
        return self.tables.field

    @property
    def erased(self) -> tuple[int, ...]:
        """Sorted erased codeword positions; `run` returns their symbols."""
        return self.tables.erased

    @property
    def kept(self) -> tuple[int, ...]:
        """The K survivor positions whose symbols `run`/`data` consume,
        in input-row order."""
        return self.tables.kept

    @property
    def D(self) -> np.ndarray:
        """(K, |E|) repair matrix: erased symbols are v^T D per column."""
        return self.tables.D

    def _check(self, v) -> tuple[np.ndarray, bool]:
        v = np.asarray(v)
        if v.shape[0] != self.spec.K:
            raise ValueError(
                f"v must carry the K={self.spec.K} survivor symbols of "
                f"plan.kept along its leading dim, got {v.shape}")
        return (v[:, None], True) if v.ndim == 1 else (v, False)

    def run(self, v) -> np.ndarray:
        """Recompute the erased symbols: v (K,)/(K, W) survivor symbols
        ordered like `plan.kept` -> (|E|,)/(|E|, W) repaired symbols
        ordered like `plan.erased`."""
        v, squeeze = self._check(v)
        if not self.erased:
            y = np.zeros((0, v.shape[1]), np.int64)
        else:
            y = get_backend(self.backend).decode(self, v)
        return y[:, 0] if squeeze else y

    def data(self, v) -> np.ndarray:
        """Decode the full original data x (K, W) from the survivors (the
        degraded-read path).  Runs the `gf_matmul` kernel with S^-1 on the
        plan's device for the Fermat field, the exact host matmul
        otherwise — bitwise identical."""
        v, squeeze = self._check(v)
        f = self.field
        if f.q == FERMAT_Q:
            from ..kernels.ops import decode_blocks

            if self._Dd is None:
                self._Dd = torch.as_tensor(
                    (self.tables.Dd % f.q).astype(np.int32),
                    device=self.device)
            Dd = self._Dd
            x = run_on_device(lambda vd: decode_blocks(vd, Dd), v, f.q,
                              self.device, "local_data",
                              kind=self.spec.kind, K=self.spec.K)
        else:
            x = f.matmul(self.tables.Dd.T, v)
        return x[:, 0] if squeeze else x

    def cost(self) -> LinearCost:
        """Closed-form (C1, C2) of the round-network decode schedule, with
        the spec's payload width W folded into C2 (Encoder convention)."""
        c = decode_cost(self.spec.K, len(self.erased), self.spec.p)
        return LinearCost(c.C1, c.C2 * self.spec.W)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class Decoder:
    """Namespace for the decode plan-then-execute API (all classmethods)."""

    ALPHA = ALPHA_DEFAULT
    BETA_BITS = BETA_BITS_DEFAULT

    @classmethod
    def plan(cls, spec: CodeSpec, erased, backend: str = "local",
             A: np.ndarray | None = None, *, device=None) -> DecodePlan:
        """Plan a decode of the given erasure pattern.

        erased : iterable of codeword positions in [0, K + R); data symbol
                 k is position k, parity symbol r is position K + r.
                 At most R positions may be erased.
        backend: a registered backend name ("local" built in; see
                 `api.register_backend`), capability-checked here
        A      : explicit generator block for kind="universal"/"lagrange"
                 specs — must match the block the data was encoded with.
        device : the torch device the plan runs on; None means "cuda",
                 and a missing card then raises RuntimeError.
        """
        get_backend(backend).validate(spec, op="decode")
        device = resolve_device(device)
        erased = tuple(sorted({int(e) for e in erased}))
        if erased and not (0 <= erased[0] and erased[-1] < spec.N):
            raise ValueError(
                f"erased positions must lie in [0, {spec.N}), got {erased}")
        if len(erased) > spec.R:
            raise ValueError(
                f"{len(erased)} erasures exceed the code's R={spec.R}")
        digest = _digest(A)
        plan_key = (spec, erased, backend, digest, device)
        hit = _lru_get(_DPLANS, plan_key)
        if hit is not None:
            _DSTATS["plan_hits"] += 1
            return hit
        _DSTATS["plan_misses"] += 1
        tables = _decode_tables(spec, erased, A, digest)
        plan = DecodePlan(spec, backend, tables, device=device)
        _lru_put(_DPLANS, plan_key, plan, _DPLANS_MAX)
        return plan

    @classmethod
    def cache_info(cls) -> dict[str, int]:
        return dict(_DSTATS, plans=len(_DPLANS), tables=len(_DTABLES))

    @classmethod
    def cache_clear(cls) -> None:
        """Drop the decode-side caches (plans + decode tables); for a
        coordinated clear of both stacks use `repro_torch.api.cache_clear()`."""
        _clear_decoder_state()


def _clear_decoder_state() -> None:
    _DPLANS.clear()
    _DTABLES.clear()
    for k in _DSTATS:
        _DSTATS[k] = 0
