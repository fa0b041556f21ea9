"""Closed loop, one client, in cycles of repair while processors are down.

A cycle on stored codeword s (in turn from a pool made from the seed, each
encoded in set-up by the plain reference):
1. `fail` e processors; the decode planner runs right after
   (`system.decode_plan`, timed as `plan_decode`), and the failed rows of
   the stored codeword are lost (zeroed);
2. `reads_per_cycle` degraded `read`s of the stored codeword;
3. one `rebuild`, which heals; its rebuilt rows are stored back.
e covers [erasures_min, erasures_max] by quarters: each block of four
cycles takes one e from each quarter (block b steps through each quarter
from its middle, starting at quarter b mod 4), the same e's in the same
order for every seed, so every seed does the same repair work.  The
positions are drawn from the seed, uniform among the N processors.  The op
in flight at the deadline completes and counts.

Parameters (traffic file): `pool_stripes`, `erasures_min`,
`erasures_max`, `reads_per_cycle`, `sample_share`, `sample_max`, and
`host_heap` (see `coding.host_heap`).
"""
from __future__ import annotations

import time

import numpy as np

from .. import op_bytes, reference
from ..coding import (Code, Data, Sampler, build_kernels, host_heap, rng,
                      warm_heap)
from .closed_codeword import program_system

MAX_CYCLES = 256
STRATA = 4
STEP = 5  # coprime with a quarter's width (16): 16 blocks take every e


def cycle_plan(seed: int, N: int, lo: int, hi: int,
               cycles: int = MAX_CYCLES) -> list[np.ndarray]:
    """The failed positions of each cycle (sorted), from the seed."""
    r = rng(seed, 3)
    edges = np.linspace(lo, hi + 1, STRATA + 1).astype(int)
    out = []
    for b in range(cycles // STRATA + 1):
        for q in ((b + 3 * j) % STRATA for j in range(STRATA)):
            width = max(1, int(edges[q + 1] - edges[q]))
            e = int(edges[q]) + (width // 2 + b * STEP) % width
            out.append(np.sort(r.choice(N, size=e, replace=False)))
    return out[:cycles]


class Cell:
    system_factory = staticmethod(program_system)

    def __init__(self, config, traffic, seed, device, rec):
        self.code = Code.of(config)
        self.traffic, self.seed, self.device, self.rec = (traffic, seed,
                                                          device, rec)
        self.kept: list = []

    def prepare(self):
        c, t = self.code, self.traffic
        host_heap(t, self.device)
        with self.rec.phase("kernels"):
            self.rec.counts["compiled"] = build_kernels(self.device)
        with self.rec.phase("program"):
            self.system = self.system_factory(c, self.device)
        with self.rec.phase("inputs"):
            data = Data(self.seed, self.device)
            self.pool = [data.stripe(c.K, c.W)
                         for _ in range(int(t["pool_stripes"]))]
        with self.rec.phase("reference_inputs", reference=True):
            A = reference.rs_generator(c.K, c.R)
            self.store = [reference.codeword(x, A, self.device)
                          for x in self.pool]
        self.cycles = cycle_plan(self.seed, c.N, int(t["erasures_min"]),
                                 int(t["erasures_max"]))
        self.first = int(rng(self.seed, 1).integers(len(self.pool)))
        self.sampler = Sampler(self.seed, t["sample_share"], t["sample_max"])

    def _lose(self, s: int, pos) -> None:
        self.store[s][pos] = 0

    def warm(self):
        # one whole cycle at the widest pattern, on a pattern no cycle uses
        c = self.code
        pos = np.sort(rng(self.seed, 4).choice(
            c.N, size=int(self.traffic["erasures_max"]), replace=False))
        s = self.first
        self.system.fail(pos.tolist())
        self.system.decode_plan
        self._lose(s, pos)
        self.system.read(self.store[s])
        healed = self.system.rebuild(self.store[s])
        self.store[s][pos] = healed[pos]
        self.system.heal()
        warm_heap(self.traffic, self.device,
                  int(self.traffic["sample_max"]) * c.N * c.W * 8)

    def window(self, seconds):
        c, rec, t = self.code, self.rec, self.traffic
        deadline = rec.window_start + seconds
        n_reads = int(t["reads_per_cycle"])
        ops = cycle = 0
        while time.perf_counter() < deadline:
            s = (self.first + cycle) % len(self.pool)
            pos = self.cycles[cycle % len(self.cycles)]
            e, e_data = len(pos), int(np.count_nonzero(pos < c.K))
            self.system.fail(pos.tolist())
            with rec.timed("plan_decode"):
                self.system.decode_plan
            self._lose(s, pos)
            for _ in range(n_reads):
                if time.perf_counter() >= deadline:
                    break
                with rec.op("read", user_bytes=op_bytes.user_bytes(c.K, c.W),
                            bound_bytes=op_bytes.read_bytes(c.K, c.W, e_data)):
                    out = self.system.read(self.store[s])
                ops += 1
                if self.sampler.take():
                    self.kept.append(("read", s, out))
            if time.perf_counter() >= deadline:
                break
            with rec.op("rebuild", user_bytes=op_bytes.user_bytes(c.K, c.W),
                        bound_bytes=op_bytes.rebuild_bytes(c.K, c.W, e)):
                healed = self.system.rebuild(self.store[s])
            ops += 1
            self.store[s][pos] = healed[pos]
            if self.sampler.take():
                self.kept.append(("rebuild", s, healed))
            cycle += 1
        rec.counts["ops"] = ops
        rec.counts["cycles_completed"] = cycle

    def finish(self):
        pass

    def release(self):
        self.system.heal()
        self.system.close()
        self.system = None
        self.store = None

    def check(self, tally):
        c = self.code
        A = reference.rs_generator(c.K, c.R)
        want = {}
        for op, s, out in self.kept:
            if op == "read":
                tally.compare(out, self.pool[s])
                continue
            if s not in want:
                want[s] = reference.codeword(self.pool[s], A, self.device)
            tally.compare(out, want[s])
        self.kept.clear()
