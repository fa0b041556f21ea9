"""plan_decode_ms.span (ms; program spans): the decode planner, timed by
the program.  Per `plan_decode` span of the benchmark (around
`system.decode_plan` right after each `fail`), the program's `plan` spans
inside it (track `planner`: `Decoder.plan`, with its rank search, inverse
and repair matrix inside).  Mean over those that hold one; nothing for a
program without planner spans."""
from portbench.spans import mean, spans, within


def read(rec):
    plans = [e for e in spans(rec, "planner") if e["name"] == "plan"]
    inside = [within(plans, b) for b in spans(rec, "bench", "plan_decode")]
    return mean(sum(e["dur"] for e in got) / 1e3 for got in inside if got)
