"""copy_ms.direct (ms a op; program spans): the host-device copies of
`run_on_device`.  Per op, the `h2d` and `d2h` spans inside the benchmark's
span around the call.  Mean over the window's ops."""
from portbench.spans import COPIES, mean, per_op


def read(rec):
    return mean(sum(e["dur"] for e in legs if e["name"] in COPIES) / 1e3
                for op, legs in per_op(rec) if legs)
