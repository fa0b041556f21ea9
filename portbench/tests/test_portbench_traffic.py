"""Seeded traffic is deterministic, and every seed offers the same work in
another order."""
import numpy as np
import pytest
import torch

from portbench import coding
from portbench.harness import Record, files
from portbench.tests.small import small
from portbench.traffic import closed_codeword, closed_repair

REPAIR = files("paper-rs-256-64.repair")[1]


@pytest.mark.parametrize("cell, per_op", [("paper-rs-256-64.encode", 1),
                                          ("hdfs-rs-6-3.encode", 64)])
def test_codeword_pool_is_stripes_side_by_side(cell, per_op):
    _, config, tr = small(cell)
    assert tr["stripes_per_op"] == per_op
    rec = Record(cell, config, tr, 2**31 + 3, 1.0)
    c = closed_codeword.Cell(config, tr, rec.seed, "cpu", rec)
    c.prepare()
    assert len(c.pool) == tr["pool_stripes"] // per_op
    for x in c.pool:
        assert x.shape == (config["K"], per_op * config["shard_symbols"])
    c.release()


def test_repair_cycles_deterministic_and_stratified():
    a = closed_repair.cycle_plan(2**31 + 7, 320, 1, 64)
    b = closed_repair.cycle_plan(2**31 + 7, 320, 1, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = closed_repair.cycle_plan(12, 320, 1, 64)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    # the same e's in the same order for every seed
    assert [len(p) for p in a] == [len(p) for p in c]
    for block in range(0, len(a), 4):
        es = sorted(len(p) for p in a[block:block + 4])
        # one e from each quarter of 1..64
        assert [(e - 1) // 16 for e in es] == [0, 1, 2, 3]
    # 16 blocks take every e of 1..64
    assert sorted({len(p) for p in a[:64]}) == list(range(1, 65))
    for p in a:
        assert len(set(p.tolist())) == len(p) and p.min() >= 0 and p.max() < 320
        assert np.all(np.diff(p) > 0)
    assert REPAIR["erasures_max"] == 64


def test_data_and_sampler_follow_the_seed():
    d1, d2 = coding.Data(2**31 + 1, "cpu"), coding.Data(2**31 + 1, "cpu")
    x, y = d1.stripe(6, 128), d2.stripe(6, 128)
    np.testing.assert_array_equal(x, y)
    assert x.dtype == np.int64 and x.min() >= 0 and x.max() < 1 << 16
    assert not np.array_equal(x, coding.Data(5, "cpu").stripe(6, 128))
    s1, s2 = coding.Sampler(3, 0.5, 4), coding.Sampler(3, 0.5, 4)
    picks = [s1.take() for _ in range(50)]
    assert picks == [s2.take() for _ in range(50)] and sum(picks) == 4


def test_seed_above_63_bits_is_accepted():
    coding.Data(2**64 + 5, "cpu").stripe(1, 4)
    coding.rng(-3, 1).random()
    assert torch.Generator().manual_seed(coding.seed64(2**70)).initial_seed() >= 0


def test_host_heap_is_a_traffic_setting_for_the_card():
    assert REPAIR["host_heap"] == "kept"
    for tr in ({}, {"host_heap": "default"}, {"host_heap": "kept"}):
        coding.host_heap(tr, "cpu")  # a CPU run keeps its process as it is
    with pytest.raises(ValueError):
        coding.host_heap({"host_heap": "huge"}, "cpu")
        coding.warm_heap(tr, "cpu", 1 << 40)  # nothing allocated here
