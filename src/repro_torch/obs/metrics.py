"""One labeled counter/gauge/histogram registry for every layer's stats.

The repo grew five disconnected stats surfaces (`RunStats`, `PlanStats`,
`StreamStats`, `QueueStats`, `ServiceStats`); this module is the single
registry they all publish into, so one `snapshot()` answers "what has
this process done" across simulator runs, stream chunks, queue batches,
and tenant ops — surfaced via `CodedSystem.stats()["metrics"]`,
`CodedService.stats()["metrics"]`, and `serve --metrics` (text
exposition format, `render_text`).

    from repro_torch.obs import metrics

    RUNS = metrics.REGISTRY.counter("coded_runs_total", "plan executions")
    RUNS.inc(1, backend="simulator", op="encode")
    metrics.REGISTRY.snapshot()   # {"coded_runs_total": {...}, ...}

Metric objects are cheap label-resolving handles; values live in the
registry under (name, sorted-label-items) keys behind one lock, so a
concurrent `snapshot()` always sees a consistent point-in-time tree
(asserted by the tier-1 consistency hammer).
"""
from __future__ import annotations

import threading


class _Metric:
    """One named metric family; label values are passed per call."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._reg = registry
        self.name = name
        self.help = help
        # (sorted label items) -> value; guarded by the registry lock
        self._values: dict[tuple, object] = {}

    @staticmethod
    def _key(labels: dict) -> tuple:
        return tuple(sorted(labels.items()))


class Counter(_Metric):
    """Monotonically increasing count (ops, rounds, elements, bytes)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0) + n


class Gauge(_Metric):
    """A value that goes both ways (in-flight ops, pool sizes)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._reg._lock:
            self._values[self._key(labels)] = value

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0) + n


class Histogram(_Metric):
    """Streaming count/sum/min/max per labelset (latencies, widths,
    group sizes) — enough for means and extremes without bucket config."""

    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._reg._lock:
            agg = self._values.get(key)
            if agg is None:
                self._values[key] = [1, value, value, value]
            else:
                agg[0] += 1
                agg[1] += value
                if value < agg[2]:
                    agg[2] = value
                if value > agg[3]:
                    agg[3] = value


class MetricsRegistry:
    """Process-wide named metric families behind one lock (see module
    docstring).  `counter`/`gauge`/`histogram` get-or-create a family —
    re-asking for a name returns the same handle, so call sites can keep
    module-level references with zero lookup on the hot path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    # -- export --------------------------------------------------------------
    @staticmethod
    def _label_str(key: tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in key)

    def snapshot(self) -> dict:
        """A consistent point-in-time tree:
        {name: {"kind", "help", "values": {label-string: value}}} with
        histogram values as {"count", "sum", "min", "max", "mean"}."""
        with self._lock:
            out: dict = {}
            for name, m in sorted(self._metrics.items()):
                vals: dict = {}
                for key, v in m._values.items():
                    ls = self._label_str(key)
                    if m.kind == "histogram":
                        cnt, s, lo, hi = v
                        vals[ls] = {"count": cnt, "sum": s, "min": lo,
                                    "max": hi, "mean": s / cnt}
                    else:
                        vals[ls] = v
                out[name] = {"kind": m.kind, "help": m.help, "values": vals}
            return out

    def render_text(self, prefix: str = "repro_") -> str:
        """Text exposition format (the `serve --metrics` dump):
        `# HELP` / `# TYPE` headers plus one `name{labels} value` line per
        labelset; histograms expose `_count`/`_sum`/`_min`/`_max`."""
        lines: list[str] = []
        for name, fam in self.snapshot().items():
            full = prefix + name
            if fam["help"]:
                lines.append(f"# HELP {full} {fam['help']}")
            lines.append(f"# TYPE {full} {fam['kind']}")
            for ls, v in sorted(fam["values"].items()):
                lbl = ("{" + ",".join(
                    f'{p.split("=", 1)[0]}="{p.split("=", 1)[1]}"'
                    for p in ls.split(",")) + "}") if ls else ""
                if fam["kind"] == "histogram":
                    for suffix in ("count", "sum", "min", "max"):
                        lines.append(f"{full}_{suffix}{lbl} {v[suffix]}")
                else:
                    lines.append(f"{full}{lbl} {v}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Drop every value (keeps the registered families) — tests and
        bench sections that need a clean ledger start here."""
        with self._lock:
            for m in self._metrics.values():
                m._values.clear()


# the process-wide registry every instrumented layer publishes into
REGISTRY = MetricsRegistry()
