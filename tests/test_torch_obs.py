"""The port's host spans (`repro_torch.obs.trace.host_span`): free when no
tracer is installed, and counting the thread's page faults when one is."""
import resource

import numpy as np
import pytest
import torch

from repro_torch.api import CodedSystem, CodeSpec, cache_clear
from repro_torch.core.field import FERMAT_Q
from repro_torch.obs import trace

RNG = np.random.default_rng(41)


def _raise(*a, **k):
    raise AssertionError("called with no tracer installed")


@pytest.mark.parametrize("op", ["codeword", "read", "rebuild", "decode_plan"])
def test_port_host_spans_cost_nothing_without_a_tracer(op, monkeypatch):
    assert trace.get_tracer() is None
    cache_clear()  # the planner's spans run, not its cache alone
    t = CodedSystem(CodeSpec(kind="rs", K=8, R=4), backend="local",
                    device="cpu")
    x = RNG.integers(0, FERMAT_Q, (8, 5))
    cw = t.codeword(x)
    t.fail([1, 9])
    monkeypatch.setattr(resource, "getrusage", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    if op == "codeword":
        assert np.array_equal(t.codeword(x), cw)
    elif op == "read":
        assert np.array_equal(t.read(cw), x)
    elif op == "rebuild":
        assert np.array_equal(t.rebuild(cw), cw)
    else:
        assert t.decode_plan.erased == (1, 9)


def test_port_host_span_counts_page_faults_of_fresh_memory():
    with trace.installed() as t:
        with trace.host_span("idle", "test"):
            pass
        with trace.host_span("touch", "test", cat="c", n=1) as args:
            a = np.ones(64 << 17, np.int64)  # 64 MiB, every page written
            args["sum"] = int(a[::4096].sum())
    idle, touch = t.events()
    assert (idle["name"], touch["name"]) == ("idle", "touch")
    assert touch["args"]["minflt"] > 0
    assert touch["args"]["minflt"] > idle["args"]["minflt"]
    assert touch["args"]["n"] == 1 and touch["args"]["sum"] == 2048
    assert touch["cat"] == "c"


def test_port_host_span_is_kept_when_its_block_raises():
    with trace.installed() as t:
        with pytest.raises(KeyError):
            with trace.host_span("fails", "test", erased=2) as args:
                args["hit"] = False
                raise KeyError("x")
    (e,) = t.events()
    assert e["name"] == "fails" and "cat" not in e
    assert e["args"]["erased"] == 2 and e["args"]["hit"] is False
    assert e["args"]["minflt"] >= 0


KERNELS = ("local_encode", "local_data", "local_decode")


@pytest.mark.parametrize("op", ["codeword", "read", "rebuild"])
def test_port_op_spans_take_residues_on_the_device(op):
    """A traced op: `host_in` says the residues were taken on the device,
    the session names the answer's rows in a `session.assemble` span, no
    leg lies inside a session span, and only the kernels' own leg bears a
    kernel's name (the rooflines read the kernels by those names)."""
    t = CodedSystem(CodeSpec(kind="rs", K=8, R=4), backend="local",
                    device="cpu")
    x = RNG.integers(-FERMAT_Q, 2 * FERMAT_Q, (8, 5))
    cw = t.codeword(x)
    if op != "codeword":
        t.fail([1, 9])
        t.decode_plan
    with trace.installed() as tracer:
        getattr(t, op)(x if op == "codeword" else cw)
    tracks = {e["args"]["name"]: e["pid"]
              for e in tracer.to_dict()["traceEvents"]
              if e["name"] == "process_name"}
    legs = [e for e in tracer.events() if e["pid"] == tracks["backend"]]
    session = [e for e in tracer.events() if e["pid"] == tracks["session"]]
    assert [e["args"]["on_card"] for e in legs
            if e["name"] == "host_in"] == [True]
    assert [e["name"] for e in session] == ["assemble"]
    for s in session:
        for e in legs:
            assert (e["ts"] >= s["ts"] + s["dur"]
                    or e["ts"] + e["dur"] <= s["ts"]), (s["name"], e["name"])
    kernel = [e["name"] for e in legs if e["name"].startswith(KERNELS)]
    assert kernel == [{"codeword": "local_encode.ntt", "read": "local_data",
                       "rebuild": "local_decode"}[op]]
    assert {"residues_dev", "d2h", "host_out"} <= {e["name"] for e in legs}
