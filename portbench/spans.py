"""Readers' helpers over a traced run's host spans (the program's
`obs.trace` spans and the benchmark's own, on one clock, microseconds).

Tracks: `bench` (the benchmark's `op.<op>` spans around each call, and
`plan_decode`), `backend` (the program's `run_on_device` legs: `host_in`,
`h2d`, the kernels' span, `d2h`, `host_out`; each ends in a device
synchronise under a tracer).
"""
from __future__ import annotations

COPIES = ("h2d", "d2h")
HOST_LEGS = ("host_in", "host_out")


def spans(rec, track: str, prefix: str = "") -> list[dict]:
    return sorted((e for e in rec.spans or ()
                   if e["track"] == track and e["name"].startswith(prefix)),
                  key=lambda e: e["ts"])


def within(inner: list[dict], outer: dict) -> list[dict]:
    t0, t1 = outer["ts"], outer["ts"] + outer["dur"]
    return [e for e in inner if e["ts"] >= t0 and e["ts"] + e["dur"] <= t1]


def per_op(rec) -> list[tuple[dict, list[dict]]]:
    """Each benchmark op span with the program's backend legs inside it."""
    legs = spans(rec, "backend")
    return [(op, within(legs, op)) for op in spans(rec, "bench", "op.")]


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None
