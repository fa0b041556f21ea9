"""The plain reference against the program on the CPU, at small widths, for
both configurations (and a small structured code besides)."""
import numpy as np
import pytest

from portbench import reference
from portbench.tests.small import small

from repro_torch.api import CodedSystem, CodeSpec, Encoder

CODES = [(256, 64), (6, 3), (16, 4)]


@pytest.mark.parametrize("K, R", CODES)
def test_generator_is_the_programs(K, R):
    plan = Encoder.plan(CodeSpec(kind="rs", K=K, R=R), backend="local",
                        device="cpu")
    np.testing.assert_array_equal(reference.rs_generator(K, R), plan.A % 65537)


def test_construction_refuses_what_the_program_refuses():
    with pytest.raises(ValueError):
        reference.rs_points(10, 4)


@pytest.mark.parametrize("cell", ["paper-rs-256-64.encode", "hdfs-rs-6-3.encode"])
def test_codeword_read_rebuild_match_the_program(cell):
    _, config, _ = small(cell)
    K, R, W = config["K"], config["R"], config["shard_symbols"]
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 16, (K, W))
    A = reference.rs_generator(K, R)
    G = reference.generator_matrix(K, R)
    system = CodedSystem(CodeSpec(kind="rs", K=K, R=R), device="cpu")
    cw = reference.codeword(x, A)
    np.testing.assert_array_equal(system.codeword(x), cw)
    for e in (1, R // 2, R):
        failed = sorted(rng.choice(K + R, e, replace=False).tolist())
        lost = cw.copy()
        lost[failed] = 0
        system.fail(failed)
        np.testing.assert_array_equal(reference.read(lost, G, failed), x)
        np.testing.assert_array_equal(system.read(lost), x)
        np.testing.assert_array_equal(reference.rebuild(lost, G, failed), cw)
        np.testing.assert_array_equal(system.rebuild(lost), cw)
        assert system.failed == ()


def test_inverse_mod():
    rng = np.random.default_rng(1)
    m = rng.integers(0, 65537, (12, 12))
    inv = reference.inverse_mod(m)
    np.testing.assert_array_equal(m @ inv % 65537, np.eye(12, dtype=np.int64))
    with pytest.raises(ValueError):
        reference.inverse_mod(np.ones((3, 3), np.int64))


def test_float32_is_not_exact():
    """The control's precision loses answers that float64 keeps."""
    import torch

    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 16, (6, 256))
    A = reference.rs_generator(6, 3)
    exact = reference.encode(x, A)
    assert np.array_equal(exact, (A.T.astype(object) @ x.astype(object)) % 65537)
    low = reference.encode(x, A, dtype=torch.float32)
    assert np.count_nonzero(low != exact) > 0
