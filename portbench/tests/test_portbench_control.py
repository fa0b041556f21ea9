"""`correct` separates sound runs from broken ones: at a small width on the
CPU, every cell comes out correct as the program runs it, and not correct
with the control (the reference in float32 in the program's place) or with
the timed path broken underneath in each way the cell can break."""
import numpy as np
import pytest

from portbench import control
from portbench.tests.small import run

from repro_torch.api import CodedSystem, backends
from repro_torch.recover import backends as rbackends
from repro_torch.recover import planner as rplanner

CELLS = ["paper-rs-256-64.encode", "paper-rs-256-64.repair",
         "hdfs-rs-6-3.encode"]


def numbers(out):
    return {c["name"]: c["value"] for c in out["checks"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, _ = run(cell)
    assert out["correct"], out["checks"]
    assert numbers(out)["answers_compared"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    out, _ = run(cell, install=control.install)
    assert not out["correct"]
    assert numbers(out)["mismatched_symbols"] > 0


# -- faults planted in the timed path ---------------------------------------

def _patch_run_on_device(monkeypatch, wrap):
    real = backends.run_on_device

    def broken(fn, x, q, device, name, **kw):
        return wrap(real, fn, x, q, device, name, **kw)
    for mod in (backends, rbackends, rplanner):
        monkeypatch.setattr(mod, "run_on_device", broken)


def altered_answer(monkeypatch):
    """One symbol of an answer altered where the device produced it."""
    def wrap(real, fn, x, *a, **kw):
        y = real(fn, x, *a, **kw)
        y[0, 0] = (y[0, 0] + 1) % 65537
        return y
    _patch_run_on_device(monkeypatch, wrap)


def half_the_batch(monkeypatch):
    """Only the first half of the columns computed, the rest left at 0."""
    def wrap(real, fn, x, *a, **kw):
        x = np.asarray(x)
        h = x.shape[1] // 2
        y = real(fn, x[:, :h], *a, **kw)
        return np.concatenate([y, np.zeros((y.shape[0], x.shape[1] - h),
                                           y.dtype)], 1)
    _patch_run_on_device(monkeypatch, wrap)


def state_unchanged(monkeypatch):
    """A rebuild that hands back the codeword it was given."""
    def rebuild(self, v):
        self.heal()
        return np.asarray(v) % 65537
    monkeypatch.setattr(CodedSystem, "rebuild", rebuild)


FAULTS = {"altered_answer": altered_answer, "half_the_batch": half_the_batch,
          "state_unchanged": state_unchanged}
# the exchange between chips has no place in these one-chip cells; a
# rebuild is the only op that returns the state it is given
CASES = [(c, f) for c in CELLS for f in FAULTS
         if f != "state_unchanged" or c == "paper-rs-256-64.repair"]


@pytest.mark.parametrize("cell, fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out, _ = run(cell, seconds=0.8, sample_share=1.0, sample_max=64)
    assert not out["correct"], (cell, fault, out["checks"])
