"""The paper's own workload: decentralized encoding of a systematic
Reed-Solomon code — a `CodedSystem` session for the encode + degraded
read, with the universal-vs-specific schedule comparison planned through
the still-public `Encoder.plan` layer underneath (both the Table-I model
cost and the simulator-measured C = alpha*C1 + beta*log2(q)*C2).

The port of `examples/decentralized_encode_demo.py` on `repro_torch`.  The
simulator runs on the host and touches no device; `--device` (default the
card, raising without one; `--device cpu` for the plain versions) is
checked as by the other examples."""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.api import CodedSystem, CodeSpec, Encoder, LinkModel
from repro_torch.api.registry import resolve_device

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args().device)

    K, R, W = 256, 64, 8  # 256 sources, 64 parity sinks, 8-symbol payloads
    spec = CodeSpec(kind="rs", K=K, R=R, W=W)
    f = spec.field
    print(f"decentralized encoding: K={K} sources, R={R} sinks, W={W}, "
          f"F_{f.q}")
    x = f.rand((K, W), np.random.default_rng(0))

    # the session API: encode, lose R processors, read through the failure
    system = CodedSystem(spec, backend="simulator", link=LinkModel())
    cw = system.codeword(x)
    assert np.array_equal(cw[K:], f.matmul(system.encode_plan.A.T, x))
    system.fail(range(R))              # the R worst-case data erasures
    assert np.array_equal(system.read(cw), x % f.q)
    print(f"auto-selected method for this spec: {system.encode_plan.method}"
          f" (degraded read through {R} failures verified)")
    system.heal()

    # planner layer: pin each schedule and compare measured network costs
    plan_u = Encoder.plan(spec, backend="simulator", method="universal")
    plan_r = Encoder.plan(spec, backend="simulator", method="rs")
    y_u, y_r = plan_u.run(x), plan_r.run(x)
    assert np.array_equal(y_u, y_r) and np.array_equal(y_u, cw[K:])

    alpha, beta_bits = Encoder.ALPHA, Encoder.BETA_BITS
    for name, plan in [("universal (prepare-and-shoot)", plan_u),
                       ("RS-specific (2x draw-and-loose)", plan_r)]:
        st = plan.last_stats  # this thread's last measured run
        print(f"  {name:32s} C1={st.C1:3d} rounds  C2={st.C2:4d} elems  "
              f"C={st.total(alpha, beta_bits) * 1e6:.1f} us (measured on "
              f"the round network)")
    c2_u, c2_r = plan_u.last_stats.C2, plan_r.last_stats.C2
    print(f"  C2 reduction from the paper's specific algorithm: "
          f"{c2_u - c2_r} field elements ({100 * (1 - c2_r / c2_u):.0f}%)")
