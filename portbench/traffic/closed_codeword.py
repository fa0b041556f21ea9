"""Closed loop, one client: `CodedSystem.codeword(x)` until the window's
end; the op in flight at the deadline completes and counts.  An op's x is
`stripes_per_op` stripes side by side, (K, stripes_per_op * W): the stripes
a coding service holds in flight, coded in one call (a column of x is one
codeword).  The inputs are drawn in turn from a pool of `pool_stripes`
stripes made from the seed.

Parameters (traffic file): `pool_stripes`, `stripes_per_op` (divides
`pool_stripes`), the answers kept for the check (`sample_share`,
`sample_max`).
"""
from __future__ import annotations

import time

from .. import op_bytes, reference
from ..coding import Code, Data, Sampler, build_kernels, rng


def program_system(code: Code, device: str):
    from repro_torch.api import CodedSystem

    return CodedSystem(code.spec(), backend=code.backend, device=device)


class Cell:
    system_factory = staticmethod(program_system)

    def __init__(self, config, traffic, seed, device, rec):
        self.code = Code.of(config)
        self.traffic, self.seed, self.device, self.rec = (traffic, seed,
                                                          device, rec)
        self.kept: list = []

    def prepare(self):
        c = self.code
        with self.rec.phase("kernels"):
            self.rec.counts["compiled"] = build_kernels(self.device)
        with self.rec.phase("program"):
            self.system = self.system_factory(c, self.device)
        per_op = int(self.traffic["stripes_per_op"])
        self.width = per_op * c.W
        with self.rec.phase("inputs"):
            data = Data(self.seed, self.device)
            self.pool = [data.stripe(c.K, self.width) for _ in
                         range(int(self.traffic["pool_stripes"]) // per_op)]
        self.first = int(rng(self.seed, 1).integers(len(self.pool)))
        self.sampler = Sampler(self.seed, self.traffic["sample_share"],
                               self.traffic["sample_max"])

    def warm(self):
        self.system.codeword(self.pool[self.first])

    def window(self, seconds):
        c, rec = self.code, self.rec
        deadline = rec.window_start + seconds
        i = 0
        while time.perf_counter() < deadline:
            s = (self.first + i) % len(self.pool)
            with rec.op("codeword",
                        user_bytes=op_bytes.user_bytes(c.K, self.width),
                        bound_bytes=op_bytes.encode_bytes(c.K, c.R,
                                                          self.width)):
                out = self.system.codeword(self.pool[s])
            if self.sampler.take():
                self.kept.append((s, out))
            i += 1
        rec.counts["ops"] = i

    def finish(self):
        pass

    def release(self):
        self.system.close()
        self.system = None

    def check(self, tally):
        c = self.code
        A = reference.rs_generator(c.K, c.R)
        want = {}
        for s, out in self.kept:
            if s not in want:
                want[s] = reference.codeword(self.pool[s], A, self.device)
            tally.compare(out, want[s])
        self.kept.clear()
