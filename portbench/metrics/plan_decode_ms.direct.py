"""plan_decode_ms.direct (ms; host clock): the decode planner.  Mean of the
benchmark's span around `system.decode_plan` right after each `fail`: the
work the next `read` would do, cached once done."""


def read(rec):
    xs = rec.timings.get("plan_decode", [])
    return sum(xs) / len(xs) * 1e3 if xs else None
