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
is structured).  Every plan's round program is one `core.schedule.RoundIR`
(`plan.schedule_ir()`): the simulator backend executes it, the mesh
backend runs the same method's rounds on its processors, and the local
backend runs no schedule but reports the same method and program.
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
from . import backends as _backends  # noqa: F401 — registers the built-ins
from .registry import PlanStats, get_backend, plan_device
from .spec import CodeSpec

# default link model used for auto selection and describe(): ~10us latency,
# 17 bits/ns-class links (the constants the demos/benchmarks report with)
ALPHA_DEFAULT = 1e-5
BETA_BITS_DEFAULT = 17e-9


# ---------------------------------------------------------------------------
# host-side tables (cached per spec, W-independent)
# ---------------------------------------------------------------------------

@dataclass
class HostTables:
    """Everything host-side a plan needs: the generator block, the structured
    code (when any), the schedule IR per method, the NTT fast-path
    constants and the mesh tables."""

    spec: CodeSpec
    field: Field
    A: np.ndarray                      # (K, R) generator block
    sgrs: StructuredGRS | None
    _ntt: Any = "unset"                # lazy NTTEncodeParams | None
    _ir: dict = dc_field(default_factory=dict)  # method -> RoundIR
    _mesh: dict = dc_field(default_factory=dict)  # method -> mesh tables

    def encode_ir(self, method: str):
        """The canonical (placement-free) `core.schedule.RoundIR` of the
        full framework encode for `method`, built and `validate()`d once
        per table set — every backend lowers from this one program."""
        if method not in self._ir:
            from ..core.schedule import build_encode_ir

            self._ir[method] = build_encode_ir(
                self.spec, method=method, A=self.A,
                sgrs=self.sgrs).validate()
        return self._ir[method]

    def mesh_tables(self, method: str):
        """`core.parity.ParityTables` of the framework grid for the mesh
        backend, built once per method."""
        if method not in self._mesh:
            from ..core.parity import build_encode_tables

            self._mesh[method] = build_encode_tables(
                self.field, self.A, p=self.spec.p, method=method,
                sgrs=self.sgrs)
        return self._mesh[method]

    def dft_mesh_tables(self):
        """The mesh backend's radix-2 DFT stage tables, built once."""
        if "dft" not in self._mesh:
            from ..core.shardmap_exec import build_dft_tables

            self._mesh["dft"] = build_dft_tables(self.field, self.spec.K,
                                                 self.spec.K)
        return self._mesh["dft"]

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


def _ir_tiered_cost(tables: HostTables, method: str,
                    placement: Placement) -> TieredCost | None:
    """Per-tier cost derived from the canonical schedule IR — the fallback
    pricing for placement profiles with no closed form (e.g. the K < R
    broadcast phase on a host boundary)."""
    try:
        a = tables.encode_ir(method).attribute(placement)
    except Exception:  # noqa: BLE001 — pricing fallback must never raise
        return None
    W = tables.spec.W
    return TieredCost(LinearCost(a["intra"][0], a["intra"][1] * W),
                      LinearCost(a["inter"][0], a["inter"][1] * W))


def _resolve_method(spec: CodeSpec, tables: HostTables | None, method: str,
                    placement: Placement | None = None, link=None
                    ) -> tuple[str, dict[str, LinearCost]]:
    sgrs = tables.sgrs if tables is not None else None
    costs = method_costs(spec, sgrs)
    if method == "auto":
        # argmin of the linear cost (W already folded into each C2);
        # specific schedule wins exact ties.  Under a placement and a
        # tiered link model, each method is priced by its per-tier split
        # (IR-derived when the closed form doesn't apply, flat as a last
        # resort) — topology can flip the choice when one schedule keeps
        # more traffic intra.
        if placement is not None and isinstance(link, TieredLinkModel):
            def _score(m: str) -> float:
                tc = tiered_encode_cost(spec, m, placement, sgrs=sgrs)
                if tc is None and tables is not None:
                    tc = _ir_tiered_cost(tables, m, placement)
                return link.us(tc if tc is not None else costs[m])
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

@dataclass
class EncodePlan(PlanStats):
    """An executable encode: spec + resolved method + backend + host tables
    + the device it runs on.

    Obtained from `Encoder.plan`; cached, so hold on to it (or re-call
    `Encoder.plan` — both hit the cache) and call `.run` per payload.

    Plans are shared across callers AND threads; per-run measurements
    (`last_stats`, `sim_net`, `stream_stats` — see `registry.PlanStats`)
    are thread-local, so every thread reads the stats of its own last run.
    """

    op = "encode"  # stream/backend dispatch discriminator (not a field)

    spec: CodeSpec
    backend: str
    method: str
    tables: HostTables
    costs: dict[str, LinearCost]
    device: Any = None                 # torch.device (None: host-only)
    # hierarchical-topology context (see repro_torch.topo): placement drives
    # the simulator's per-tier accounting, link the tiered pricing of
    # describe()/auto selection
    placement: Placement | None = None
    topology: Topology | None = None
    link: Any = None
    # run the tier_commute rewrite pass over the schedule IR (requires a
    # placement; the simulator backend executes the rewritten program)
    commute: bool = False
    _local_fn: Callable | None = None
    _mesh_fn: Callable | None = None
    _ir: Any = None                    # lazily-resolved plan-level RoundIR
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
        """Streamed encode: generator of (R, w) sink blocks.

        `payload` is a (K, W) array (split into chunks of width `chunk_w`,
        default `stream.plan_chunk_w(plan)`) or an iterable of (K, w_i)
        chunks (streamed as given, re-split only above chunk_w).
        Concatenating the yielded blocks is bitwise-equal to `run` on the
        concatenated payload.  On the local backend the chunks run through
        the device pipeline on `plan.device`; on the simulator backend,
        `plan.stream_stats` carries exact per-chunk C1/C2.
        """
        from . import stream

        return stream.run_stream(self, payload, chunk_w=chunk_w)

    def run_batched(self, xs, *, chunk_w: int | None = None) -> list[np.ndarray]:
        """Encode a batch of payloads (each (K,) or (K, W_i)) in one
        coalesced streamed execution; returns per-payload sink values."""
        from . import stream

        return stream.run_batched(self, xs, chunk_w=chunk_w)

    # -- streaming adapter (see api/stream.py) ------------------------------
    def _stream_sim_chunk(self, x: np.ndarray):
        from .backends import run_simulator

        return run_simulator(self, x)  # (y, RoundNetwork) pair

    def schedule_ir(self):
        """The plan's `core.schedule.RoundIR`: the canonical per-method
        program from the host tables, with `tier_commute(placement)`
        applied when the plan was built with `commute=True`.  Cached for
        the plan's lifetime (tables cache the canonical IR per method)."""
        if self._ir is None:
            ir = self.tables.encode_ir(self.method)
            if self.commute and self.placement is not None:
                ir = ir.tier_commute(self.placement)
            self._ir = ir
        return self._ir

    def mesh_callable(self):
        """The mesh program (mesh backend only): this rank's (K/G, w) int32
        block on `plan.device` -> (R, w) sink values ((K, w) for dft);
        built once, its table rows moved to the device once, kept for the
        plan's lifetime."""
        if self._mesh_fn is None:
            from .backends import build_mesh_callable

            self._mesh_fn = build_mesh_callable(self)
        return self._mesh_fn

    @property
    def local_impl(self) -> str:
        """Which kernel the local backend runs: "ntt" (O(K log K) fast
        path) or "dense" (field-matmul `encode_blocks`)."""
        return "ntt" if self.tables.ntt_params() is not None else "dense"

    def cost(self) -> LinearCost:
        """(C1, C2) of the chosen schedule per the Table-I cost model
        (the canonical schedule — a commuted plan's exact counts come from
        `schedule_ir().cost()`, see `obs.drift`)."""
        return self.costs[self.method]

    def tiered_cost(self) -> TieredCost | None:
        """Exact per-tier (intra, inter) split of `cost()` under the plan's
        placement; None without a placement or when the placement has no
        closed form (the simulator's measured `sim_net.by_tier()` still
        applies).  A `commute=True` plan's split comes from its rewritten
        schedule IR — that is the program its runs execute."""
        if self.placement is None:
            return None
        if self.commute:
            a = self.schedule_ir().attribute(self.placement)
            W = self.spec.W
            return TieredCost(
                LinearCost(a["intra"][0], a["intra"][1] * W),
                LinearCost(a["inter"][0], a["inter"][1] * W))
        return tiered_encode_cost(self.spec, self.method, self.placement,
                                  sgrs=self.sgrs)

    def describe(self) -> str:
        s = self.spec
        c = self.cost()
        model_us = c.total(ALPHA_DEFAULT, BETA_BITS_DEFAULT) * 1e6
        lines = [
            f"EncodePlan[{s.kind}] K={s.K} R={s.R} p={s.p} W={s.W} q={s.q}",
            f"  backend : {self.backend}",
            f"  method  : {self.method} "
            f"(available: {', '.join(sorted(self.costs))})",
            f"  cost    : C1={c.C1} rounds, C2={c.C2} elems/port "
            f"(model C ~ {model_us:.1f} us)",
            f"  tables  : cached, key={s.table_key()}",
            f"  schedule: {self.schedule_ir().summary(self.placement)}",
        ]
        if self.topology is not None:
            t = self.topology
            pol = self.placement.policy if self.placement else "none"
            lines.append(f"  topo    : {t.hosts} hosts x "
                         f"{t.devices_per_host} devices, placement={pol}")
            tc = self.tiered_cost()
            if tc is not None:
                us = (self.link.us(tc)
                      if isinstance(self.link, TieredLinkModel) else None)
                lines.append(
                    f"  tiers   : intra C1={tc.intra.C1} C2={tc.intra.C2} | "
                    f"inter C1={tc.inter.C1} C2={tc.inter.C2}"
                    + (f" (model C ~ {us:.1f} us)" if us is not None else ""))
        line = get_backend(self.backend).describe_line(self)
        if line is not None:
            lines.append(line)
        return "\n".join(lines)


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
             link=None, commute: bool = False, device=None) -> EncodePlan:
        """Plan an encode: resolve the algorithm, build-or-reuse host tables,
        and return the cached executable plan.

        backend : a registered backend name — "local" | "simulator" |
                  "mesh" built in, plus anything added via
                  `api.register_backend` (capability-checked here, at
                  plan time)
        method  : "auto" (cost-model argmin) | "universal" | "rs" | "dft"
        A       : explicit (K, R) generator block — required for
                  kind="universal" specs without a seed; allowed for
                  kind="lagrange" with arbitrary (unstructured) points.
        topology: a `repro_torch.topo.Topology` (placed with the affinity
                  policy when it has enough slots) or an explicit
                  `Placement`; with a `TieredLinkModel` link, "auto" prices
                  each method by its per-tier split.  The mesh backend
                  classifies its legs by tier (`ProcMesh.legs`) when the
                  host count divides K.
        link    : `LinkModel` or `repro_torch.topo.TieredLinkModel`.
        commute : apply the `RoundIR.tier_commute` rewrite pass under the
                  resolved placement (required): the commuting reduce
                  rounds are re-synthesized host-aware so inter-host
                  rounds strictly shrink (or the schedule is unchanged).
                  Simulator runs execute the rewritten program.
        device  : the torch device the plan runs on; None means "cuda",
                  and a missing card then raises RuntimeError (pass
                  device="cpu" for the kernels' plain versions).  A
                  host-only backend (the simulator) touches no device:
                  there `device` is moot and the plan's is None.
        """
        get_backend(backend).validate(spec, op="encode")
        device = plan_device(backend, device)
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
        if commute and placement is None:
            raise ValueError(
                "commute=True requires a placement — pass topology= (a "
                "Topology with enough slots, or an explicit Placement)")
        digest = _digest(A)
        plan_key = (spec, backend, method, digest, placement, topo, link,
                    commute, device)
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
                          link=link, commute=commute)
        _PLANS[plan_key] = plan
        return plan

    @classmethod
    def auto_method(cls, spec: CodeSpec) -> str:
        """The method `method="auto"` resolves to for this spec."""
        tables = None
        if spec.structured():
            tables = _host_tables(spec, None, None)
        return _resolve_method(spec, tables, "auto")[0]

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
