"""Low-overhead span/event tracer with Chrome trace-event JSON export.

One `Tracer` collects timestamped events from every layer — simulator
rounds, stream pipeline stages, queue executions, service ops — onto
named (process, thread) tracks and exports the standard Chrome
trace-event format, loadable in perfetto (https://ui.perfetto.dev) or
chrome://tracing:

    from repro_torch.obs import trace

    tracer = trace.install(trace.Tracer())
    ...                        # anything that runs emits onto it
    trace.uninstall(tracer)
    tracer.save("out.json")

Instrumented call sites key off the *installed* tracer (`get_tracer()`),
so tracing needs no parameter plumbing through cached plans or networks
constructed deep inside framework code — and when nothing is installed
every hook is a single `is None` check: tracing off costs nothing
measurable.

Track names are strings (`pid="simulator"`, `tid="proc 3"`); the trace
format wants integers, so the tracer interns them and emits the
`process_name` / `thread_name` metadata events perfetto uses for labels.
Timestamps are wall-clock microseconds from one process-wide epoch, so
the layers' spans line up with each other on the tracer's timeline.

The program's host spans open through `host_span` (and `kernel_span`, for
the legs of a device call), which also opens a
`torch.profiler.record_function` range: `<track>.<name>` (a kernel span's
range is its bare name).  So under `torch.profiler` every span reaches the
device trace as a range of its own, and the kernels and copies it launched
are placed under it there (a span on another thread than the profiler's,
such as the coding queue's worker, only when the profiler profiles every
thread: `_ExperimentalConfig(profile_all_threads=True)`).  Each such span
records in its args `minflt`, the minor page faults its thread took inside
it (0 on a host whose kernel counts none).
"""
from __future__ import annotations

import json
import resource
import threading
from contextlib import contextmanager
from time import perf_counter_ns


class Tracer:
    """Thread-safe in-memory event collector (Chrome trace-event model).

    Events: `complete(...)` is a closed span ("X": ts + dur), `span(...)`
    a context manager measuring one, `instant(...)` a zero-duration mark
    ("i") — kills, aborts, state flips.  All take `pid`/`tid` track names
    (str or raw int) plus optional `cat` and an `args` dict shown in the
    viewer's detail pane.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[int, str], int] = {}
        # one process-wide epoch so every layer's timestamps align
        self._t0 = perf_counter_ns()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def now_us(self) -> float:
        """Microseconds since this tracer's epoch (wall clock)."""
        return (perf_counter_ns() - self._t0) / 1e3

    # -- track interning -----------------------------------------------------
    def _pid(self, pid) -> int:
        if isinstance(pid, int):
            return pid
        n = self._pids.get(pid)
        if n is None:
            n = self._pids[pid] = len(self._pids) + 1
            self._events.append({
                "name": "process_name", "ph": "M", "pid": n, "tid": 0,
                "args": {"name": pid}})
        return n

    def _tid(self, pid: int, tid) -> int:
        if isinstance(tid, int):
            return tid
        key = (pid, tid)
        n = self._tids.get(key)
        if n is None:
            n = self._tids[key] = len(self._tids) + 1
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": n,
                "args": {"name": tid}})
        return n

    # -- emission ------------------------------------------------------------
    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid="main", tid="main", cat: str = "",
                 args: dict | None = None) -> None:
        """A closed span: began at `ts_us`, lasted `dur_us` (both in
        microseconds on this tracer's clock — see `now_us`)."""
        ev = {"name": name, "ph": "X", "ts": ts_us,
              "dur": max(dur_us, 0.001)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        with self._lock:
            p = self._pid(pid)
            ev["pid"], ev["tid"] = p, self._tid(p, tid)
            self._events.append(ev)

    def instant(self, name: str, *, ts_us: float | None = None,
                pid="main", tid="main", cat: str = "",
                args: dict | None = None) -> None:
        """A zero-duration mark (kill, abort, state flip)."""
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self.now_us() if ts_us is None else ts_us}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        with self._lock:
            p = self._pid(pid)
            ev["pid"], ev["tid"] = p, self._tid(p, tid)
            self._events.append(ev)

    @contextmanager
    def span(self, name: str, *, pid="main", tid="main", cat: str = "",
             args: dict | None = None):
        """Measure the with-block as one complete event."""
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, self.now_us() - t0, pid=pid, tid=tid,
                          cat=cat, args=args)

    # -- export --------------------------------------------------------------
    def events(self, *, cat: str | None = None,
               name: str | None = None) -> list[dict]:
        """A snapshot of collected events, optionally filtered (metadata
        events excluded) — the programmatic side of the export, used by
        trace-correctness tests."""
        with self._lock:
            evs = list(self._events)
        out = []
        for e in evs:
            if e["ph"] == "M":
                continue
            if cat is not None and e.get("cat") != cat:
                continue
            if name is not None and e.get("name") != name:
                continue
            out.append(e)
        return out

    def to_dict(self) -> dict:
        """The full trace as the Chrome trace-event JSON object."""
        with self._lock:
            return {"traceEvents": [dict(e) for e in self._events],
                    "displayTimeUnit": "ms"}

    def save(self, path) -> str:
        """Write the trace JSON to `path`; returns the path written."""
        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh)
        return str(path)


# ---------------------------------------------------------------------------
# the installed-tracer stack (what instrumented call sites consult)
# ---------------------------------------------------------------------------

_INSTALLED: list[Tracer] = []


def install(tracer: Tracer) -> Tracer:
    """Make `tracer` the active tracer every instrumented call site emits
    to (a stack — nesting installs is fine); returns it for chaining."""
    _INSTALLED.append(tracer)
    return tracer


def uninstall(tracer: Tracer) -> None:
    """Remove `tracer` from the active stack (no-op if absent)."""
    for i in range(len(_INSTALLED) - 1, -1, -1):
        if _INSTALLED[i] is tracer:
            del _INSTALLED[i]
            return


def get_tracer() -> Tracer | None:
    """The currently installed tracer, or None (the common, free case)."""
    return _INSTALLED[-1] if _INSTALLED else None


def resolve(trace) -> tuple[Tracer | None, str | None]:
    """Normalize a user-facing `trace=` argument — the shape
    `CodedSystem(trace=...)` / `CodedService(trace=...)` accept:

        None/False     -> (None, None)         tracing off
        True           -> (new Tracer, None)   collect, caller exports
        a Tracer       -> (it, None)           caller-owned
        a path (str)   -> (new Tracer, path)   saved on close()
    """
    if trace is None or trace is False:
        return None, None
    if trace is True:
        return Tracer(), None
    if isinstance(trace, Tracer):
        return trace, None
    return Tracer(), str(trace)


@contextmanager
def installed(tracer: Tracer | None = None):
    """`with trace.installed() as t:` — install for the block's duration."""
    t = tracer or Tracer()
    install(t)
    try:
        yield t
    finally:
        uninstall(t)


def _minflt() -> int:
    """Minor page faults the calling thread has taken so far."""
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt


@contextmanager
def _ranged(tracer: Tracer, name: str, range_name: str, *, pid, tid, cat,
            args: dict, sync: bool = False):
    """One profiler range `range_name` around the with-block and, inside
    it, one tracer span, with the thread's minor page faults in
    `args["minflt"]`; `sync` ends it with a device synchronise.  The span
    is written after the range closes, so the two differ by the range's
    own entry and exit alone."""
    import torch

    rf = torch.profiler.record_function(range_name)
    f0 = _minflt()
    rf.__enter__()
    t0 = tracer.now_us()
    try:
        yield args
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        t1 = tracer.now_us()
        rf.__exit__(None, None, None)
        args["minflt"] = _minflt() - f0
        tracer.complete(name, t0, t1 - t0, pid=pid, tid=tid, cat=cat,
                        args=args)


@contextmanager
def host_span(name: str, track: str, *, tid="main", cat: str = "", **args):
    """Wrap host work: a span `name` on the installed tracer's `track` and a
    `torch.profiler.record_function("<track>.<name>")` range, with the
    thread's minor page faults in `args["minflt"]`.  It never synchronises
    the device.  Yields the span's args dict, which the block may add to
    before the span closes.  Free (one `is None` check; no torch import, no
    `getrusage`) when no tracer is installed."""
    tracer = get_tracer()
    if tracer is None:
        yield args
        return
    with _ranged(tracer, name, f"{track}.{name}", pid=track, tid=tid,
                 cat=cat, args=args):
        yield args


@contextmanager
def kernel_span(name: str, **args):
    """Wrap one leg of a device call: a span on the "backend"/"kernels"
    track AND a `torch.profiler.record_function(name)` range, with the
    thread's minor page faults in `args["minflt"]`.  With a tracer installed
    the span ends with a device synchronise, so its duration covers the
    kernels it launched (not just their enqueue).  Yields the span's args
    dict, which the block may add to, as `host_span` does.  Free (and
    torch-import-free) when no tracer is installed."""
    tracer = get_tracer()
    if tracer is None:
        yield args
        return
    with _ranged(tracer, name, name, pid="backend", tid="kernels",
                 cat="kernel", args=args, sync=True):
        yield args
