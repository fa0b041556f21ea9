"""host_ms.direct (ms a op; program spans): the session's host prep.  Per
op, the benchmark's span around the call minus the program's `h2d`, kernel
and `d2h` spans inside it; what is left is `host_in`, `host_out` and the
session's slicing and concatenation.  Mean over the window's ops."""
from portbench.spans import HOST_LEGS, mean, per_op


def read(rec):
    return mean((op["dur"] - sum(e["dur"] for e in legs
                                 if e["name"] not in HOST_LEGS)) / 1e3
                for op, legs in per_op(rec) if legs)
