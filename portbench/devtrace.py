"""The device side of a traced run, read from `torch.profiler`'s trace.

The profiler's Chrome trace carries, on one clock:
- device events: kernels (`kernel`), copies (`gpu_memcpy`, `gpu_memset`);
- the host's runtime calls that launched them (`cuda_runtime`,
  `cuda_driver`), joined to them by `args.correlation`;
- host ranges (`user_annotation`): the benchmark's `bench.*` ranges and
  the program's `kernel_span` names (`host_in`, `h2d`, `local_encode.ntt`,
  `local_decode`, `local_data`, `d2h`, `host_out`).

A device event belongs to the host ranges that were open when it was
launched.  Times are microseconds as the trace has them; the readers turn
them into the units they report.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclass
class DeviceTrace:
    device: list[dict] = field(default_factory=list)   # name cat ts dur launch
    ranges: list[dict] = field(default_factory=list)   # name ts dur
    window: tuple[float, float] | None = None
    _rkeys: list = field(default_factory=list, repr=False)
    _lkeys: list = field(default_factory=list, repr=False)

    @classmethod
    def from_events(cls, events: list[dict]) -> "DeviceTrace":
        launches: dict[int, float] = {}
        dev, ranges = [], []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[int(args["correlation"])] = float(e["ts"])
            elif cat in DEVICE_CATS:
                dev.append({"name": e.get("name", "?"), "cat": cat,
                            "ts": float(e["ts"]), "dur": float(e["dur"]),
                            "corr": args.get("correlation")})
            elif cat == "user_annotation":
                r = {"name": e.get("name", "?"), "ts": float(e["ts"]),
                     "dur": float(e["dur"])}
                ranges.append(r)
                if r["name"] == WINDOW:
                    window = (r["ts"], r["ts"] + r["dur"])
        for d in dev:
            c = d.pop("corr")
            # a device event without its launch (rare) is placed by its start
            d["launch"] = launches.get(int(c), d["ts"]) if c is not None \
                else d["ts"]
        dev.sort(key=lambda d: d["launch"])
        ranges.sort(key=lambda r: r["ts"])
        return cls(dev, ranges, window)

    @classmethod
    def load(cls, path) -> "DeviceTrace":
        with open(path) as fh:
            return cls.from_events(json.load(fh).get("traceEvents", []))

    # -- queries ---------------------------------------------------------------
    def _range_keys(self) -> list[float]:
        if len(self._rkeys) != len(self.ranges):
            self._rkeys = [r["ts"] for r in self.ranges]
        return self._rkeys

    def _launch_keys(self) -> list[float]:
        if len(self._lkeys) != len(self.device):
            self._lkeys = [d["launch"] for d in self.device]
        return self._lkeys

    def launched_in(self, r: dict, cats=("kernel",)) -> list[dict]:
        """Device events of `cats` launched inside host range `r`."""
        keys = self._launch_keys()
        lo = bisect.bisect_left(keys, r["ts"])
        hi = bisect.bisect_right(keys, r["ts"] + r["dur"])
        return [d for d in self.device[lo:hi] if d["cat"] in cats]

    def busy(self) -> list[tuple[float, float]]:
        """Merged intervals in which a device event ran, clipped to the
        window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        spans = sorted((max(d["ts"], w0), min(d["ts"] + d["dur"], w1))
                       for d in self.device)
        out: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy())

    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def idle_pct(self) -> float | None:
        """Share of the window with no kernel and no copy on the card; None
        without a window or without any device event to read."""
        if self.window_us() <= 0 or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_us() / self.window_us())

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the window."""
        if self.window is None:
            return []
        out, t = [], self.window[0]
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def open_range(self, t: float) -> str:
        """The innermost host range open at time t, other than the window:
        the latest started that still covers t, since ranges nest
        (`bench.<op>#<i>` reads as `bench.<op>`)."""
        i = bisect.bisect_right(self._range_keys(), t)
        for r in reversed(self.ranges[max(0, i - 5000):i]):
            if r["name"] != WINDOW and r["ts"] + r["dur"] >= t:
                return r["name"].split("#")[0]
        return "no host range"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time by the host
        range open during it, in seconds."""
        by_op: dict[str, float] = {}
        w0, w1 = self.window or (float("-inf"), float("inf"))
        for d in self.device:
            if w0 <= d["ts"] <= w1:
                by_op[d["name"]] = by_op.get(d["name"], 0.0) + d["dur"] / 1e6
        by_gap: dict[str, float] = {}
        keys = self._range_keys()
        for s, e in self.gaps():
            # split the gap where a host range starts or ends inside it
            cuts = {s, e}
            for r in self.ranges[max(0, bisect.bisect_left(keys, s) - 5000):
                                 bisect.bisect_right(keys, e)]:
                cuts.update(t for t in (r["ts"], r["ts"] + r["dur"])
                            if s < t < e)
            cuts = sorted(cuts)
            for a, b in zip(cuts, cuts[1:]):
                name = self.open_range((a + b) / 2)
                by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gaps]}
