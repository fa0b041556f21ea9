"""assemble_ms.span (ms a op; program spans): the session's moving of rows.
Per op, the session's `gather` (survivor rows picked out) and `assemble`
(the codeword concatenated, rebuilt rows scattered) spans inside the
benchmark's span around the call (track `session`).  Mean over the ops
that `host_ms.direct` counts; nothing for a program without session
spans."""
from portbench.spans import mean, per_op, spans, within


def read(rec):
    session = spans(rec, "session")
    if not session:
        return None
    moved = [e for e in session if e["name"] in ("gather", "assemble")]
    return mean(sum(e["dur"] for e in within(moved, op)) / 1e3
                for op, legs in per_op(rec) if legs)
