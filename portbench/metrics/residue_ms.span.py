"""residue_ms.span (ms a op; program spans): the session's residues and
casts.  Per op, inside the benchmark's span around the call: the
`run_on_device` legs `host_in` and `host_out` (track `backend`) and the
session's `residues` spans (track `session`).  Mean over the ops that
`host_ms.direct` counts; nothing for a program without session spans."""
from portbench.spans import HOST_LEGS, mean, per_op, spans, within


def read(rec):
    session = spans(rec, "session")
    if not session:
        return None
    residues = [e for e in session if e["name"] == "residues"]
    return mean((sum(e["dur"] for e in legs if e["name"] in HOST_LEGS)
                 + sum(e["dur"] for e in within(residues, op))) / 1e3
                for op, legs in per_op(rec) if legs)
