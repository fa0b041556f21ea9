"""The control of `correct`: the plain reference, put in the program's place
and computed in float32 with TF32 off, the precision below the float64 in
which the reference is exact.  Over F_65537 a product needs 34 bits and a
row sum up to 42, so float32 loses the answer: the comparison has to call
such a run not correct.

Runs a cell's own traffic, at its own size, for a short window, once a seed,
in one process; prints each seed's compared numbers:

    python portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0:1] = [_root, os.path.join(_root, "src")]

import torch  # noqa: E402

from portbench import reference  # noqa: E402

LOW = torch.float32


class ControlSystem:
    """`CodedSystem`'s ops as the benchmark calls them, by the reference in
    float32."""

    def __init__(self, code, device):
        self.device = device
        self.A = reference.rs_generator(code.K, code.R)
        self.G = reference.generator_matrix(code.K, code.R)
        self.failed: set[int] = set()

    def codeword(self, x):
        return reference.codeword(x, self.A, self.device, LOW)

    def fail(self, procs):
        self.failed |= {int(p) for p in procs}

    def heal(self, procs=None):
        self.failed.clear()

    @property
    def decode_plan(self):
        return sorted(self.failed)

    def read(self, v):
        return reference.read(v, self.G, sorted(self.failed), self.device, LOW)

    def rebuild(self, v):
        out = reference.rebuild(v, self.G, sorted(self.failed), self.device,
                                LOW)
        self.heal()
        return out

    def close(self):
        pass


def install(cell) -> None:
    """Put the control in the program's place in a driver."""
    cell.system_factory = ControlSystem


def main(argv=None) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config, traffic = harness.files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = harness.Record(args.workload, config, traffic, seed,
                             args.seconds)
        cell = harness.driver(traffic["kind"]).Cell(config, traffic, seed,
                                                    args.device, rec)
        install(cell)
        out = harness.run_cell(cell, rec, time.perf_counter(), args.device)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
