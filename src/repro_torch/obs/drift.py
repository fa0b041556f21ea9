"""Predicted-vs-measured ledger: does the closed-form cost model still
match what the simulator measures?

The repo's correctness story rests on exact accounting: the Table-I /
Theorem-7 closed forms (`EncodePlan.cost()`, `recover.engine.decode_cost`,
`cost_universal_exact`) must equal the `RoundNetwork`'s measured (C1, C2)
bit for bit.  Tests assert this for fixed specs; the ledger asserts it
*continuously*: every simulator-backed run (`PlanStats._record_net`)
compares its measured counts against the model re-evaluated at the run's
actual payload width and records exact-match or drift per
(spec, backend, op, method).  Any drift is a broken schedule or a broken
model — `LEDGER.drifted()` surfaces it, `describe()` renders the ledger,
and tier-1 fails loudly on a nonzero drift count.

Leaf-module discipline: the cost model is imported lazily per call (the
`api`/`recover` planners import the obs package, not the other way
round at module scope).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field

from .metrics import REGISTRY

_MODEL_RUNS = REGISTRY.counter(
    "cost_model_runs_total",
    "simulator runs checked against the closed-form cost model")

# expected-(C1, C2) memo: the model is pure in (spec, op-detail, width),
# so re-deriving it per chunk would dominate small simulator runs
_EXPECTED: dict[tuple, tuple[int, int]] = {}
_EXPECTED_MAX = 4096


@dataclass
class DriftEntry:
    """Ledger line for one (spec, backend, op, detail) cell — `detail` is
    the resolved encode method, or the erasure-pattern size for decode."""

    spec: object
    backend: str
    op: str
    detail: str
    runs: int = 0
    exact: int = 0
    drifted: int = 0
    last_mismatch: dict | None = dc_field(default=None, repr=False)

    def snapshot(self) -> dict:
        s = self.spec
        return {
            "spec": f"{s.kind} K={s.K} R={s.R} p={s.p}",
            "backend": self.backend, "op": self.op, "detail": self.detail,
            "runs": self.runs, "exact": self.exact, "drifted": self.drifted,
            "last_mismatch": self.last_mismatch,
        }


class DriftLedger:
    """Aggregated predicted-vs-measured results (see module docstring)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: dict[tuple, DriftEntry] = {}

    def record(self, spec, backend: str, op: str, detail: str,
               expected: tuple[int, int], measured: tuple[int, int],
               *, width: int) -> None:
        key = (spec, backend, op, detail)
        exact = expected == measured
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = DriftEntry(spec, backend, op,
                                                    detail)
            e.runs += 1
            if exact:
                e.exact += 1
            else:
                e.drifted += 1
                e.last_mismatch = {"expected": expected,
                                   "measured": measured, "width": width}
        _MODEL_RUNS.inc(1, kind=spec.kind, op=op,
                        status="exact" if exact else "drift")

    def entries(self) -> list[DriftEntry]:
        with self._lock:
            return list(self._entries.values())

    def drifted(self) -> list[DriftEntry]:
        """Every cell where the model and the simulator EVER disagreed —
        empty is the healthy (and tier-1-asserted) state."""
        return [e for e in self.entries() if e.drifted]

    def snapshot(self) -> dict:
        ents = self.entries()
        return {
            "runs": sum(e.runs for e in ents),
            "exact": sum(e.exact for e in ents),
            "drifted": sum(e.drifted for e in ents),
            "entries": [e.snapshot() for e in ents],
        }

    def describe(self) -> str:
        ents = self.entries()
        if not ents:
            return "drift ledger: no simulator-backed runs recorded"
        total = sum(e.runs for e in ents)
        bad = sum(e.drifted for e in ents)
        lines = [f"drift ledger: {total} run(s), "
                 f"{'ZERO drift' if not bad else f'{bad} DRIFTED'} "
                 f"across {len(ents)} (spec, op) cell(s)"]
        for e in sorted(ents, key=lambda e: (-e.drifted, e.op)):
            s = e.spec
            line = (f"  {e.op:6s} {s.kind:9s} K={s.K} R={s.R} p={s.p} "
                    f"[{e.detail}]: {e.exact}/{e.runs} exact")
            if e.drifted:
                line += f"  DRIFT x{e.drifted}: {e.last_mismatch}"
            lines.append(line)
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


LEDGER = DriftLedger()


def _expected(plan, op: str, width: int) -> tuple[tuple[int, int], str]:
    """The closed-form (C1, C2) for one run of `plan` at payload width
    `width`, plus the ledger detail string.  Width matters: streamed runs
    execute chunk-by-chunk, so the model is re-evaluated at each chunk's
    actual width (C2 scales linearly; C1 does not)."""
    spec = plan.spec
    if op == "encode":
        if getattr(plan, "commute", False):
            # a tier_commute-rewritten schedule has no Table-I closed form;
            # its exact expectation is the rewritten IR's own accounting
            key = (spec, plan.method, width, plan.placement, "ir")
            hit = _EXPECTED.get(key)
            if hit is None:
                c1, c2 = plan.schedule_ir().cost()
                hit = (c1, c2 * width)
                if len(_EXPECTED) >= _EXPECTED_MAX:
                    _EXPECTED.clear()
                _EXPECTED[key] = hit
            return hit, f"{plan.method}/ir"
        key = (spec, plan.method, width)
        hit = _EXPECTED.get(key)
        if hit is None:
            from dataclasses import replace

            from ..api.planner import method_costs

            c = method_costs(replace(spec, W=width), plan.sgrs)[plan.method]
            hit = (c.C1, c.C2)
            if len(_EXPECTED) >= _EXPECTED_MAX:
                _EXPECTED.clear()
            _EXPECTED[key] = hit
        return hit, plan.method
    n_erased = len(plan.erased)
    key = (spec.K, spec.p, n_erased, width, "dec")
    hit = _EXPECTED.get(key)
    if hit is None:
        from ..recover.engine import decode_cost

        c = decode_cost(spec.K, n_erased, spec.p)
        hit = (c.C1, c.C2 * width)
        if len(_EXPECTED) >= _EXPECTED_MAX:
            _EXPECTED.clear()
        _EXPECTED[key] = hit
    return hit, f"|E|={n_erased}"


def _expected_tiers(plan, width: int, placement):
    """Per-tier closed form (intra C1, intra C2, inter C1, inter C2) for
    one encode at `width` under `placement`, memoized; None when the
    placement profile has no closed form (measured-only, not drift)."""
    commuted = getattr(plan, "commute", False)
    key = (plan.spec, plan.method, width, placement,
           "ir-tiers" if commuted else "tiers")
    hit = _EXPECTED.get(key, "unset")
    if hit == "unset":
        if commuted:
            # per-tier expectation of the rewritten program itself
            a = plan.schedule_ir().attribute(placement)
            hit = (a["intra"][0], a["intra"][1] * width,
                   a["inter"][0], a["inter"][1] * width)
        else:
            from dataclasses import replace

            from ..topo import tiered_encode_cost

            tc = tiered_encode_cost(replace(plan.spec, W=width), plan.method,
                                    placement, sgrs=plan.sgrs)
            hit = None if tc is None else (tc.intra.C1, tc.intra.C2,
                                           tc.inter.C1, tc.inter.C2)
        if len(_EXPECTED) >= _EXPECTED_MAX:
            _EXPECTED.clear()
        _EXPECTED[key] = hit
    return hit


def record_run(plan, net, op: str, width: int) -> None:
    """Compare one simulator-backed run against the model and ledger it.

    Called from `PlanStats._record_net` with the run's fresh
    `RoundNetwork` (its C1/C2 are exactly this run's counts) and the
    payload width the run actually executed.  Runs under a placement
    additionally assert the per-tier split (see `repro_torch.topo`) whenever
    its closed form applies."""
    try:
        expected, detail = _expected(plan, op, width)
    except Exception as exc:  # noqa: BLE001 — a model we cannot evaluate
        # is drift too (never let ledger bookkeeping fail the run itself);
        # the unequal "expected" carries the error into last_mismatch
        expected, detail = ("model-error", str(exc)), "model-error"
    LEDGER.record(plan.spec, plan.backend, op, detail, expected,
                  (net.C1, net.C2), width=width)
    placement = getattr(net, "placement", None)
    if placement is None or op != "encode":
        return
    try:
        tiers = _expected_tiers(plan, width, placement)
        tier_detail = f"{plan.method}/tiers@{placement.policy}"
    except Exception as exc:  # noqa: BLE001 — same contract as above
        tiers, tier_detail = ("model-error", str(exc)), "tiers/model-error"
    if tiers is None:
        return
    measured = (net.c1_by_tier["intra"], net.c2_by_tier["intra"],
                net.c1_by_tier["inter"], net.c2_by_tier["inter"])
    LEDGER.record(plan.spec, plan.backend, op, tier_detail, tiers, measured,
                  width=width)
