"""Masterless Lagrange coded computing (Remark 9): 5 data shards, 16
workers, straggler- and dropout-tolerant polynomial evaluation; the port
of `examples/lagrange_coded_compute.py` on `repro_torch`.

    python examples_torch/lagrange_coded_compute.py               # the card
    python examples_torch/lagrange_coded_compute.py --device cpu  # plain versions
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.api.registry import resolve_device
from repro_torch.coding import LagrangeComputer
from repro_torch.core.field import FERMAT

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args().device)

    f = FERMAT
    lcc = LagrangeComputer.build(f, K=5, N=16, device=device)
    x = f.rand((5, 4), np.random.default_rng(0))

    def poly(v):  # f(v) = v^2 + 3v + 1, degree 2
        return f.add(f.add(f.mul(v, v), f.mul(3, v)), 1)

    print(lcc.system().describe())  # the CodedSystem session behind encode
    coded = lcc.encode(x)           # paper Sec. VI / Remark 9 encode
    results = poly(coded)           # every worker computes f on its shard
    T = lcc.recovery_threshold(2)
    alive = np.random.default_rng(1).choice(16, T, replace=False)
    print(f"workers alive: {sorted(alive.tolist())} (need {T}/16)")
    decoded = lcc.decode(2, np.sort(alive), results[np.sort(alive)])
    assert np.array_equal(decoded, poly(x))
    print("OK: f(x_k) recovered exactly for all shards from", T, "of 16 workers")
