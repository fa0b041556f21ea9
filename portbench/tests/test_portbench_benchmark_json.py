"""BENCHMARK.json keeps to its contract, and everything it names is found by
name: each configuration file, each cell's traffic file and driver module,
each metric's reader."""
import os
import re

import pytest

from portbench import harness

B = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "portbench/run.py"]
    assert B["paths"] == ["portbench"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert os.path.getsize(harness.ROOT / "BENCHMARK.json") <= 64 * 1024


def test_run_seconds_fits_the_full_check_at_24_cells():
    cells = 24
    total = ((2 + 14 * cells) * (B["run_seconds"] + 60) + cells * 2 * 90
             + 1200)
    assert total <= 43200


def test_configs():
    names = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert c["file"].startswith("portbench/")
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert c["reduced"] == []  # the deployments run at their scale
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    assert len({c["file"] for c in B["configs"]}) == len(B["configs"])
    used = {w["config"] for w in B["workloads"]}
    assert used == names


def test_workloads_resolve_by_name():
    seen = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell, config, traffic = harness.resolve(w["name"])
        assert harness.driver(traffic["kind"]).Cell
    assert len({w["name"] for w in B["workloads"]}) == len(B["workloads"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"] for m in B["end_to_end"]}
    for m in B[group]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if group == "end_to_end" else {"layer", "moves"})
        assert keys <= set(m) <= keys | {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(harness.BENCH / "metrics" / f"{m['name']}.py")
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            # each listed cell reports the end-to-end metric it moves
            moved = next(x for x in B["end_to_end"] if x["name"] == m["moves"])
            assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_and_a_layer():
    assert next(m for m in B["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for w in B["workloads"]:
        e2e = harness.metric_names(w["name"], False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metric_names(w["name"], True)


def test_roofline_and_mfu_names():
    for m in B["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
