"""One run of one cell: set-up, a measured window, the check, the last line.

Everything a cell is made of is found by name (see README.md):
`BENCHMARK.json` names the cell, its configuration file and its traffic
file; the traffic file's `kind` names the driver module
`portbench/traffic/<kind>.py`; each metric is read by
`portbench/metrics/<name>.py`.

A driver is a class `Cell(config, traffic, seed, device, rec)` with
`prepare()` (inputs, the program's set-up), `warm()` (the cell's own
shapes), `window(seconds)` (the measured work, recorded on `rec`),
`finish()` (waits for answers due in the window), `release()` (frees the
program's state) and `check(tally)` (holds the answers against the plain
reference).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

from .check import Tally, passed
from .devtrace import WINDOW, DeviceTrace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool = False
    setup_s: float = math.nan
    window_start: float = math.nan    # perf_counter seconds
    window_end: float = math.nan
    reference_setup_s: float = 0.0  # the reference's part of set-up
    ops: list = field(default_factory=list)        # closed-loop ops
    timings: dict = field(default_factory=dict)    # name -> [seconds]
    counts: dict = field(default_factory=dict)
    tracer: object = None      # the program's obs.trace.Tracer (traced runs)
    tracer_window: tuple = (0.0, 0.0)  # the window on the tracer's clock, us
    spans: list | None = None  # its events, each with "track" (pid name)
    device: DeviceTrace | None = None
    device_kind: str | None = None

    def _range(self, span: str, i: int):
        """A traced run's host range: a tracer span `span` on the `bench`
        track and a profiler range `bench.<span without "op.">#<i>`."""
        if not self.trace:
            return nullcontext()
        import torch

        @contextmanager
        def both():
            with self.tracer.span(span, pid="bench", tid="client",
                                  args={"i": i}), \
                    torch.profiler.record_function(
                        f"bench.{span.removeprefix('op.')}#{i}"):
                yield
        return both()

    @contextmanager
    def op(self, name: str, **fields):
        """Time one op of a closed loop; `fields` (bytes, erasures) are kept
        with its start and end."""
        i = len(self.ops)
        t0 = time.perf_counter()
        with self._range(f"op.{name}", i):
            yield
        self.ops.append({"op": name, "i": i, "t0": t0,
                         "t1": time.perf_counter(), **fields})

    @contextmanager
    def phase(self, name: str, reference: bool = False):
        """Time a phase of set-up into `counts` (printed, not a metric).  A
        `reference` phase is the plain reference's work (inputs it makes
        for the program): it is left out of `setup_s`."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.counts[f"setup_{name}_s"] = round(dt, 3)
        if reference:
            self.reference_setup_s += dt

    @contextmanager
    def timed(self, name: str):
        """Time a step that is not an op (the decode planner)."""
        xs = self.timings.setdefault(name, [])
        t0 = time.perf_counter()
        with self._range(name, len(xs)):
            yield
        xs.append(time.perf_counter() - t0)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def resolve(cell_name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of a cell, by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"unknown workload {cell_name!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return cell, config, traffic


def files(cell_name: str) -> tuple[dict, dict]:
    """(configuration, traffic) of a cell `<config>.<mix>` by its files'
    names, listed in BENCHMARK.json or not (for the tools and tests)."""
    config = load_json(BENCH / "configs"
                       / f"{cell_name.rsplit('.', 1)[0]}.json")
    return config, load_json(BENCH / "traffic" / f"{cell_name}.json")


def metric_names(cell_name: str, trace: bool, root: Path = ROOT) -> list[str]:
    """The cell's end-to-end metrics (untraced) or per-layer metrics
    (traced): those listing the cell, and those that list none."""
    bench = load_json(root / "BENCHMARK.json")
    group = bench["per_layer" if trace else "end_to_end"]
    return [m["name"] for m in group
            if cell_name in m.get("workloads", [cell_name])]


def metric_units(root: Path = ROOT) -> dict:
    bench = load_json(root / "BENCHMARK.json")
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def read_metric(name: str, rec: Record):
    """Run `metrics/<name>.py`'s `read(rec)`: a number, or None when the run
    had nothing for it to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def driver(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def forbidden_modules() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process
    (compared by whole top-level name: `repro_torch` is not `repro`)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _parse_profile(prof) -> DeviceTrace:
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        say(f"trace: {os.path.getsize(path)} bytes")
        return DeviceTrace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_cell(cell, rec: Record, t_start: float, device: str) -> dict:
    """Drive one cell through set-up, window, check; returns the fields of
    the result line (without `metrics`)."""
    import torch

    on_card = device == "cuda"
    rec.counts["setup_before_prepare_s"] = round(time.perf_counter() - t_start,
                                                 3)
    cell.prepare()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with rec.phase("warm"):
        cell.warm()
    prof = None
    if rec.trace:
        from repro_torch.obs import trace as program_trace

        # the program's spans land on this tracer (and synchronise)
        rec.tracer = program_trace.install(program_trace.Tracer())
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    rec.window_start = time.perf_counter()
    rec.setup_s = rec.window_start - t_start - rec.reference_setup_s
    try:
        with (torch.profiler.record_function(WINDOW) if prof is not None
              else nullcontext()):
            cell.window(rec.seconds)
            if on_card:
                torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    rec.window_end = max((o["t1"] for o in rec.ops),
                         default=time.perf_counter())
    cell.finish()
    if rec.trace:
        # the tracer's clock is perf_counter's, from its own epoch
        off = rec.tracer.now_us() - time.perf_counter() * 1e6
        rec.tracer_window = (rec.window_start * 1e6 + off,
                             rec.window_end * 1e6 + off)
        rec.spans = tracer_events(rec.tracer)
        program_trace.uninstall(rec.tracer)
        rec.device = _parse_profile(prof)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    tally = Tally()
    cell.check(tally)
    checks = tally.checks()
    return {"correct": passed(checks), "attempted": len(rec.ops),
            "failed": tally.wrong_answers, "checks": checks,
            "memory_peak_bytes": peak}


def tracer_events(tracer) -> list[dict]:
    """The tracer's closed spans, each with its track's name."""
    evs = tracer.to_dict()["traceEvents"]
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    return [dict(e, track=names.get(e["pid"], str(e["pid"])))
            for e in evs if e["ph"] == "X"]


def main(argv: list[str], t_start: float, device: str = "cuda") -> int:
    """The command line; `device` is "cuda" but for a test's fake run."""
    ap = argparse.ArgumentParser(prog="portbench/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell_entry, config, traffic = resolve(args.workload)
    import torch

    chips = int(cell_entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"refused: the cell needs {chips} CUDA device(s); "
            f"available={torch.cuda.is_available()}, count="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = torch.cuda.get_device_name(0)
    say(f"card: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"nvidia-smi (name, sm clock, power, limit, temp) before: "
        f"{nvidia_smi()}")
    rec = Record(args.workload, config, traffic, args.seed, args.seconds,
                 trace=bool(args.trace), device_kind=kind)
    cell = driver(traffic["kind"]).Cell(config, traffic, args.seed, device,
                                        rec)
    out = run_cell(cell, rec, t_start, device)
    say(f"nvidia-smi after: {nvidia_smi()}")
    for k, v in sorted(rec.counts.items()):
        say(f"count {k}: {v}")
    say(f"setup_s: {rec.setup_s:.3f} (the reference's "
        f"{rec.reference_setup_s:.3f} s left out); compiling run: "
        f"{'yes' if rec.counts.get('compiled') else 'no'}, kernels "
        f"{rec.counts.get('setup_kernels_s')} s of it")
    for op in sorted({o["op"] for o in rec.ops}):
        ts = sorted(o["t1"] - o["t0"] for o in rec.ops if o["op"] == op)
        say(f"count {op}_s: n={len(ts)} min={ts[0]:.4f} "
            f"median={ts[len(ts) // 2]:.4f} max={ts[-1]:.4f}")
    say("ops in turn (s): " + " ".join(f"{o['op']}={o['t1'] - o['t0']:.3f}"
                                       for o in rec.ops))

    units = metric_units()
    metrics = {}
    for name in metric_names(args.workload, rec.trace):
        v = read_metric(name, rec)
        if v is not None:
            metrics[name] = {"value": float(v), "unit": units[name]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if rec.trace and rec.device is not None:
        device["busy_s"] = rec.device.busy_us() / 1e6
        device["window_s"] = rec.device.window_us() / 1e6
        line["breakdown"] = rec.device.breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                  "rule": c["rule"]} for c in out["checks"]}

    bad = forbidden_modules()
    if bad:
        say(f"refused: the run loaded {bad}")
        return 3
    for c in out["checks"]:
        say(f"check {c['name']}: {c['value']} (limit {c['rule']} "
            f"{c['limit']})")
    print(json.dumps(line), flush=True)
    return 0
