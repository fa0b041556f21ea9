"""On the card: a short run of a cell at a reduced width comes out correct,
and the control does not.  Skips without a card."""
import pytest

from portbench import control
from portbench.tests.small import small

pytestmark = pytest.mark.cuda

W = 1 << 14


def _run(card, cell, install=None):
    import time

    from portbench import harness

    _, config, tr = small(cell)
    config = dict(config, shard_symbols=W)
    rec = harness.Record(cell, config, tr, 2**31 + 29, 1.0)
    c = harness.driver(tr["kind"]).Cell(config, tr, rec.seed, card, rec)
    if install is not None:
        install(c)
    return harness.run_cell(c, rec, time.perf_counter(), card)


@pytest.mark.parametrize("cell", ["hdfs-rs-6-3.encode",
                                  "paper-rs-256-64.repair"])
def test_card_run_correct(card, cell):
    out = _run(card, cell)
    assert out["correct"], out["checks"]
    assert out["memory_peak_bytes"] > 0


@pytest.mark.parametrize("cell", ["hdfs-rs-6-3.encode", "paper-rs-256-64.encode"])
def test_card_control_not_correct(card, cell):
    assert not _run(card, cell, install=control.install)["correct"]
