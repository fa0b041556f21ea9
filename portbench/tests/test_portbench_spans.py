"""The program's session and planner spans in traced small runs on the CPU:
the readers that use them, and their ranges on the profiler's trace."""
import time

import pytest
import torch

from portbench import harness
from portbench.devtrace import WINDOW
from portbench.tests.small import run

CELLS = ["paper-rs-256-64.encode", "paper-rs-256-64.repair",
         "hdfs-rs-6-3.encode"]
NEW = ["residue_ms.span", "assemble_ms.span", "plan_decode_ms.span"]
RANGES = {"paper-rs-256-64.encode": {"session.residues", "session.assemble"},
          "hdfs-rs-6-3.encode": {"session.residues", "session.assemble"},
          "paper-rs-256-64.repair": {"session.gather", "planner.plan"}}


def _idle_ns() -> int:
    """Wall-clock time less the calling thread's CPU time, so far: it grows
    while the thread waits to run (switched out, or on a virtual CPU that
    its hypervisor has not scheduled)."""
    return time.perf_counter_ns() - time.thread_time_ns()


class _Counted:
    """`torch.profiler.record_function`, noting in `log`, in the order the
    ranges open, each range's name and the time (us) by which its range
    may outlast the code inside it for reasons not of that code: the
    profiler's own work to open and close the range, and the time the
    thread waited to run while it was open."""
    real = torch.profiler.record_function
    log: list = []

    def __init__(self, name, args=None):
        self.inner = self.real(name, args)
        self.entry = [name, 0.0]
        self.log.append(self.entry)

    def __enter__(self):
        t = time.perf_counter_ns()
        self.inner.__enter__()
        self.opened = time.perf_counter_ns(), _idle_ns()
        self.entry[1] = time.perf_counter_ns() - t
        return self

    def __exit__(self, *exc):
        t, idle = time.perf_counter_ns(), _idle_ns()
        self.inner.__exit__(*exc)
        self.entry[1] = (self.entry[1] + time.perf_counter_ns() - t
                         + idle - self.opened[1]) / 1e3


@pytest.fixture(scope="module")
def traced():
    """Each cell's record, and `_Counted.log` of its run."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _Counted)
        for cell in CELLS:
            _Counted.log = []
            rec = run(cell, seconds=0.3, trace=True)[1]
            out[cell] = rec, _Counted.log
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_new_readers_read_a_traced_run(cell, traced):
    rec, _ = traced[cell]
    for name in harness.metric_names(cell, True):
        if name in NEW:
            v = harness.read_metric(name, rec)
            assert isinstance(v, float) and v >= 0, (name, v)
    names = {r["name"] for r in rec.device.ranges}
    assert RANGES[cell] <= names, names
    if cell.endswith("repair"):
        assert "plan_decode_ms.span" in harness.metric_names(cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_every_program_span_is_a_profiler_range(cell, traced):
    rec, opened = traced[cell]
    program = sorted((e for e in rec.spans if e["track"] != "bench"),
                     key=lambda e: e["ts"])

    def ours(name):
        return not name.startswith("bench.") and name != WINDOW

    ranges = [r for r in rec.device.ranges if ours(r["name"])]
    excused = [us for name, us in opened if ours(name)]
    assert program and len(ranges) == len(program) == len(excused)
    for e, r, us in zip(program, ranges, excused):
        # a kernel span's range keeps its bare name
        want = (e["name"] if e["track"] == "backend"
                else f"{e['track']}.{e['name']}")
        assert r["name"] == want
        slack = max(0.1 * e["dur"], 500.0)
        assert e["dur"] - r["dur"] <= slack, (want, r["dur"], e["dur"])
        # the range's time past the span's, less what the profiler and
        # the scheduler took of it
        assert r["dur"] - e["dur"] - us <= slack, (want, r["dur"], e["dur"],
                                                   us)


def _record(spans):
    rec = harness.Record("c", {}, {}, 1, 1.0, trace=True)
    rec.spans = [dict(e, dur=e.get("dur", 10.0)) for e in spans]
    return rec


BENCH_OP = {"track": "bench", "name": "op.read", "ts": 0.0, "dur": 100.0}
LEGS = [{"track": "backend", "name": n, "ts": 10.0 * i + 1}
        for i, n in enumerate(("host_in", "h2d", "local_data", "d2h",
                               "host_out"))]


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_from_a_program_without_their_spans(name):
    # the program before its session and planner spans: backend legs alone
    rec = _record([BENCH_OP, {"track": "bench", "name": "plan_decode",
                              "ts": 200.0, "dur": 50.0}] + LEGS)
    assert harness.read_metric(name, rec) is None


def test_new_readers_sum_their_spans_per_op():
    rec = _record([
        BENCH_OP, dict(BENCH_OP, ts=1000.0, name="op.rebuild"),
        {"track": "bench", "name": "plan_decode", "ts": 200.0, "dur": 50.0},
        {"track": "planner", "name": "plan", "ts": 201.0, "dur": 40.0},
        {"track": "planner", "name": "kept", "ts": 202.0, "dur": 5.0},
        {"track": "session", "name": "gather", "ts": 0.5, "dur": 0.4},
        {"track": "session", "name": "residues", "ts": 60.0, "dur": 20.0}]
        + LEGS + [dict(e, ts=e["ts"] + 1000.0) for e in LEGS])
    assert harness.read_metric("residue_ms.span", rec) == pytest.approx(
        (40 + 20) / 2 / 1e3)
    assert harness.read_metric("assemble_ms.span", rec) == pytest.approx(
        0.4 / 2 / 1e3)
    assert harness.read_metric("plan_decode_ms.span", rec) == pytest.approx(
        40 / 1e3)
