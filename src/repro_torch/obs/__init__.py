"""Unified observability: tracing, metrics, and the cost-model drift ledger.

The paper states its whole contribution as exact communication accounting
— C1 rounds and C2 max-message-size under the linear network model — and
this package is how the repo *shows* those numbers instead of merely
asserting them in tests:

    trace   — a low-overhead span/event tracer with Chrome trace-event
              JSON export (perfetto / chrome://tracing).  The simulator
              emits per-round events on per-processor tracks, the session
              and the decode planner their host steps, the stream engine
              its H2D/compute pipeline stages, and the queue / service
              layers per-op spans tagged tenant/tag/group.  The program's
              host spans (`host_span`, `kernel_span`) also reach
              `torch.profiler`'s device trace as `<track>.<name>` ranges
              (a kernel span's bare name), with the page faults taken in
              each.
    metrics — ONE labeled counter/gauge/histogram registry the layer
              stats classes (`RunStats`, `PlanStats`, `StreamStats`,
              `QueueStats`, `ServiceStats`) publish into, snapshottable
              as a tree and rendered in text exposition format.
    drift   — a predicted-vs-measured ledger: every simulator-backed run
              compares its measured (C1, C2) against the closed-form
              cost model and records exact-match or drift per
              (spec, backend, op, method).

This package is a LEAF: it imports nothing from the rest of `repro_torch` at
module scope (the drift ledger pulls the cost model lazily, per call), so
`core.simulator` and `api.registry` may import it without cycles.
"""
from . import drift, metrics, trace
from .drift import LEDGER, DriftLedger
from .metrics import REGISTRY, MetricsRegistry
from .trace import Tracer, get_tracer, host_span, install, uninstall

__all__ = [
    "trace", "metrics", "drift",
    "Tracer", "get_tracer", "host_span", "install", "uninstall",
    "REGISTRY", "MetricsRegistry",
    "LEDGER", "DriftLedger",
]
