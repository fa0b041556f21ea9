"""The command's last line on a fake run: a CPU run made to look like one
card, at a small width."""
import json

import pytest
import torch

from portbench import harness

from portbench.tests.small import SEED, small

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    narrow = {c: small(c) for c in CELLS}
    monkeypatch.setattr(harness, "resolve", lambda name: narrow[name])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(cell, trace, fake_card, capsys):
    rc = harness.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       "0.3", "--trace", str(trace)], 0.0, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == "NVIDIA H100 80GB HBM3"
    names = set(harness.metric_names(cell, bool(trace)))
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not trace:
        # the end-to-end metrics need no device trace: all are there
        assert set(line["metrics"]) == names
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_refuses_without_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                      0.0)
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "refused" in err
