"""Encoder: the plan-then-execute encode API of the port.

    spec = CodeSpec(kind="rs", K=16, R=4)
    plan = Encoder.plan(spec, backend="local")       # method="auto", "cuda"
    y = plan.run(x)                                  # (R, W) sink values

`plan()` does all host-side work once — generator matrix / StructuredGRS
construction, cost-model algorithm selection, NTT fast-path constants — and
caches it keyed by the spec, so the hot path (`plan.run`) never rebuilds
tables.  Two cache levels:

  * table cache: `CodeSpec.table_key()` (spec minus payload width W) ->
    `HostTables`.  Shared across backends, devices and W variants.
  * plan cache: (spec, backend, method, A-digest, placement, link, device)
    -> `EncodePlan`, so a plan keeps its device constants across calls.

`method="auto"` picks the argmin of the Table-I linear cost
C = alpha*C1 + beta_bits*C2 (C2 already scaled by the spec's payload width
W) over the schedules available for the spec (universal prepare-and-shoot
always; the RS/Lagrange-specific draw-and-loose factorization when the code
is structured).  The local backend runs no schedule, but the method is part
of the plan and is reported like the JAX package's.
"""
from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

import numpy as np

from ..core import cost_model
from ..core.cauchy import StructuredGRS, cost_cauchy
from ..core.cost_model import LinearCost
from ..core.dft_a2a import cost_dft
from ..core.field import Field
from ..topo import (Placement, TieredCost, TieredLinkModel, Topology,
                    n_procs as topo_n_procs, place, tiered_encode_cost)
from . import backends as _backends  # noqa: F401 — registers "local"
from .registry import PlanStats, get_backend, resolve_device
from .spec import CodeSpec

# default link model used for auto selection: ~10us latency, 17 bits/ns-class
# links (the constants the demos/benchmarks report with)
ALPHA_DEFAULT = 1e-5
BETA_BITS_DEFAULT = 17e-9


# ---------------------------------------------------------------------------
# host-side tables (cached per spec, W-independent)
# ---------------------------------------------------------------------------

@dataclass
class HostTables:
    """Everything host-side a plan needs: the generator block, the structured
    code (when any), and the NTT fast-path constants."""

    spec: CodeSpec
    field: Field
    A: np.ndarray                      # (K, R) generator block
    sgrs: StructuredGRS | None
    _ntt: Any = "unset"                # lazy NTTEncodeParams | None

    def ntt_params(self):
        """NTT fast-path constants for the local backend (None when the
        spec has no radix-2 single-coset structure), built once."""
        if self._ntt == "unset":
            from ..kernels.ntt_encode import NTTEncodeParams

            self._ntt = NTTEncodeParams.build(self.spec, self.sgrs)
        return self._ntt


_TABLES: dict[tuple, HostTables] = {}
_PLANS: dict[tuple, "EncodePlan"] = {}
_STATS = {"table_hits": 0, "table_misses": 0,
          "plan_hits": 0, "plan_misses": 0}


def _digest(A: np.ndarray | None) -> str | None:
    if A is None:
        return None
    A = np.ascontiguousarray(np.asarray(A, np.int64))
    return hashlib.sha1(repr(A.shape).encode() + A.tobytes()).hexdigest()


def _host_tables(spec: CodeSpec, A: np.ndarray | None, digest: str | None) -> HostTables:
    key = spec.table_key() + (digest,)
    hit = _TABLES.get(key)
    if hit is not None:
        _STATS["table_hits"] += 1
        return hit
    _STATS["table_misses"] += 1
    f = spec.field
    sgrs = None
    if A is not None:
        A = f.arr(A)
        if A.shape != (spec.K, spec.R):
            raise ValueError(f"A must be ({spec.K}, {spec.R}), got {A.shape}")
        if spec.kind in ("dft", "rs"):
            raise ValueError(
                f"kind={spec.kind!r} derives its matrix from the spec; drop "
                "A (use kind='universal' or 'lagrange' for explicit matrices)")
    else:
        if spec.structured():
            sgrs = StructuredGRS.build(f, spec.K, spec.R, P=spec.P,
                                       lagrange=spec.kind == "lagrange")
            A = sgrs.grs.A_direct()
        else:
            A = spec.default_matrix(f)
    tables = HostTables(spec, f, A, sgrs)
    _TABLES[key] = tables
    return tables


# ---------------------------------------------------------------------------
# method selection (Table I cost model)
# ---------------------------------------------------------------------------

def method_costs(spec: CodeSpec, sgrs: StructuredGRS | None) -> dict[str, LinearCost]:
    """Analytic (C1, C2) of the full framework encode per available method.

    C2 is already scaled by the spec's payload width W (matching the
    measured `RoundNetwork.C2` of a W-wide run) — evaluate totals with
    `cost.total(alpha, beta_bits)` at W=1, not with W again."""
    if spec.kind == "dft":
        c1, c2 = cost_dft(spec.K, spec.P, spec.p)
        return {"dft": LinearCost(c1, c2 * spec.W)}
    out = {
        "universal": cost_model.framework(
            spec.K, spec.R, spec.p,
            cost_model.universal(min(spec.K, spec.R), spec.p), spec.W)
    }
    if sgrs is not None:
        a2a = LinearCost(*cost_cauchy(sgrs, 0, spec.p))
        out["rs"] = cost_model.framework(spec.K, spec.R, spec.p, a2a, spec.W)
    return out


def _resolve_method(spec: CodeSpec, tables: HostTables, method: str,
                    placement: Placement | None = None, link=None
                    ) -> tuple[str, dict[str, LinearCost]]:
    sgrs = tables.sgrs
    costs = method_costs(spec, sgrs)
    if method == "auto":
        # argmin of the linear cost (W already folded into each C2);
        # specific schedule wins exact ties.  Under a placement and a
        # tiered link model, each method is priced by its per-tier split.
        if placement is not None and isinstance(link, TieredLinkModel):
            def _score(m: str) -> float:
                tc = tiered_encode_cost(spec, m, placement, sgrs=sgrs)
                if tc is None:
                    # the JAX package prices this profile from its schedule
                    # IR (`core/schedule.py`), which is not ported yet
                    raise NotImplementedError(
                        f"no closed-form per-tier cost for method {m!r} under "
                        "this placement; pricing it needs the schedule IR "
                        "(ROADMAP queue 1, item 2)")
                return link.us(tc)
        elif link is not None:
            def _score(m: str) -> float:
                return link.us(costs[m])
        else:
            def _score(m: str) -> float:
                return costs[m].total(ALPHA_DEFAULT, BETA_BITS_DEFAULT)
        chosen = min(costs, key=lambda m: (_score(m), m == "universal"))
        return chosen, costs
    if method not in costs:
        raise ValueError(
            f"method {method!r} unavailable for {spec.kind!r} spec "
            f"(have {tuple(costs)})")
    return method, costs


# ---------------------------------------------------------------------------
# EncodePlan
# ---------------------------------------------------------------------------

def _not_ported(what: str, queue: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {queue})")


@dataclass
class EncodePlan(PlanStats):
    """An executable encode: spec + resolved method + backend + host tables
    + the device it runs on.

    Obtained from `Encoder.plan`; cached, so hold on to it (or re-call
    `Encoder.plan` — both hit the cache) and call `.run` per payload.
    """

    op = "encode"  # backend dispatch discriminator (not a field)

    spec: CodeSpec
    backend: str
    method: str
    tables: HostTables
    costs: dict[str, LinearCost]
    device: Any = None                 # torch.device the kernels run on
    # hierarchical-topology context (see repro_torch.topo): placement and
    # link drive the tiered pricing of auto selection and `tiered_cost`
    placement: Placement | None = None
    topology: Topology | None = None
    link: Any = None
    _local_fn: Callable | None = None
    # thread-local per-run stats storage (PlanStats reads/writes this)
    _tls: Any = dc_field(default_factory=threading.local, repr=False)

    @property
    def field(self) -> Field:
        return self.tables.field

    @property
    def A(self) -> np.ndarray:
        """The (K, R) generator block (x^T A are the sink values)."""
        return self.tables.A

    @property
    def sgrs(self) -> StructuredGRS | None:
        return self.tables.sgrs

    def run(self, x) -> np.ndarray:
        """Encode payloads x (K,) or (K, W) -> sink values (R,)/(R, W)."""
        x = np.asarray(x)
        if x.shape[0] != self.spec.K:
            raise ValueError(f"x must have leading dim K={self.spec.K}, "
                             f"got {x.shape}")
        squeeze = x.ndim == 1
        y = get_backend(self.backend).encode(self, x[:, None] if squeeze
                                             else x)
        return y[:, 0] if squeeze else y

    def run_stream(self, payload, *, chunk_w: int | None = None):
        _not_ported("streamed encode (run_stream)", "queue 1, item 5")

    def run_batched(self, xs, *, chunk_w: int | None = None):
        _not_ported("batched encode (run_batched)", "queue 1, item 5")

    def schedule_ir(self):
        _not_ported("the schedule IR (core/schedule.py)", "queue 1, item 2")

    def mesh_callable(self):
        _not_ported("the mesh backend", "queue 1, item 7")

    @property
    def local_impl(self) -> str:
        """Which kernel the local backend runs: "ntt" (O(K log K) fast
        path) or "dense" (field-matmul `encode_blocks`)."""
        return "ntt" if self.tables.ntt_params() is not None else "dense"

    def cost(self) -> LinearCost:
        """(C1, C2) of the chosen schedule per the Table-I cost model."""
        return self.costs[self.method]

    def tiered_cost(self) -> TieredCost | None:
        """Exact per-tier (intra, inter) split of `cost()` under the plan's
        placement; None without a placement or when the placement has no
        closed form."""
        if self.placement is None:
            return None
        return tiered_encode_cost(self.spec, self.method, self.placement,
                                  sgrs=self.sgrs)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class Encoder:
    """Namespace for the plan-then-execute API (all classmethods)."""

    ALPHA = ALPHA_DEFAULT
    BETA_BITS = BETA_BITS_DEFAULT

    @classmethod
    def plan(cls, spec: CodeSpec, backend: str = "local",
             method: str = "auto", A: np.ndarray | None = None, *,
             topology: Topology | Placement | None = None,
             link=None, device=None) -> EncodePlan:
        """Plan an encode: resolve the algorithm, build-or-reuse host tables,
        and return the cached executable plan.

        backend : a registered backend name — "local" built in, plus
                  anything added via `api.register_backend`
                  (capability-checked here, at plan time)
        method  : "auto" (cost-model argmin) | "universal" | "rs" | "dft"
        A       : explicit (K, R) generator block — required for
                  kind="universal" specs without a seed; allowed for
                  kind="lagrange" with arbitrary (unstructured) points.
        topology: a `repro_torch.topo.Topology` (placed with the affinity
                  policy when it has enough slots) or an explicit
                  `Placement`; with a `TieredLinkModel` link, "auto" prices
                  each method by its per-tier split.
        link    : `LinkModel` or `repro_torch.topo.TieredLinkModel`.
        device  : the torch device the plan runs on; None means "cuda",
                  and a missing card then raises RuntimeError (pass
                  device="cpu" for the kernels' plain versions).
        """
        get_backend(backend).validate(spec, op="encode")
        device = resolve_device(device)
        placement = None
        topo = None
        if topology is not None:
            if isinstance(topology, Placement):
                placement, topo = topology, topology.topology
            elif isinstance(topology, Topology):
                topo = topology
                if topology.n_slots >= topo_n_procs(spec):
                    placement = place(spec, topology, "affinity")
                elif get_backend(backend).measures_network:
                    raise ValueError(
                        f"topology has {topology.n_slots} slots < "
                        f"{topo_n_procs(spec)} processors — pass a larger "
                        "topology (or an explicit Placement) for a "
                        "network-measuring backend")
            else:
                raise TypeError(
                    f"topology must be a Topology or Placement, "
                    f"got {type(topology).__name__}")
        digest = _digest(A)
        plan_key = (spec, backend, method, digest, placement, topo, link,
                    device)
        hit = _PLANS.get(plan_key)
        if hit is not None:
            _STATS["plan_hits"] += 1
            return hit
        _STATS["plan_misses"] += 1
        tables = _host_tables(spec, A, digest)
        resolved, costs = _resolve_method(spec, tables, method,
                                          placement, link)
        plan = EncodePlan(spec, backend, resolved, tables, costs,
                          device=device, placement=placement, topology=topo,
                          link=link)
        _PLANS[plan_key] = plan
        return plan

    @classmethod
    def cache_info(cls) -> dict[str, int]:
        return dict(_STATS, plans=len(_PLANS), tables=len(_TABLES))

    @classmethod
    def cache_clear(cls) -> None:
        """Coordinated clear of ALL plan/table caches — encode plans, the
        shared host-table cache, AND the decode caches (decode tables hold
        references into the encoder's host tables)."""
        import sys

        _clear_encoder_state()
        _rplanner = sys.modules.get(
            __package__.rsplit(".", 1)[0] + ".recover.planner")
        if _rplanner is not None:
            _rplanner._clear_decoder_state()


def _clear_encoder_state() -> None:
    """Drop the encode-side caches only (see `Encoder.cache_clear`)."""
    _PLANS.clear()
    _TABLES.clear()
    for k in _STATS:
        _STATS[k] = 0
