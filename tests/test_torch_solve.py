"""The port's GF(65537) solve and `core.parity.reconstruct` against the JAX
package's, bitwise, on the CPU (`device="cpu"`: the Gauss-Jordan inverse in
plain torch, then `gf_matmul`'s plain version).

Same seeded numpy inputs through `repro` and `repro_torch`; the inverse of
a nonsingular matrix is unique and the arithmetic exact, so every output
must be equal, with no tolerance.  Singular inputs must raise the same
`ValueError`."""
import importlib
import itertools

import numpy as np
import pytest
import torch

from repro.core.cauchy import StructuredGRS as JGRS
from repro.core.field import FERMAT, Field
from repro.core.matrices import gauss_inverse
from repro.core.parity import reconstruct as j_reconstruct
from repro_torch.core.cauchy import StructuredGRS as TGRS
from repro_torch.core.field import FERMAT as TFERMAT
from repro_torch.core.field import Field as TField
from repro_torch.core.parity import reconstruct as t_reconstruct
from repro_torch.kernels import gf_gauss_inverse, gf_solve

torch.set_num_threads(1)

# the modules (each package's `kernels.gf_solve` name is the function)
jsolve = importlib.import_module("repro.kernels.gf_solve")
tsolve = importlib.import_module("repro_torch.kernels.gf_solve")

Q = 65537


def _np(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
                      np.int64)


def _nonsingular_all_minus_one(n):
    """An invertible matrix whose nonzero entries are all q - 1: the upper
    triangle (diagonal included) of the all-(q-1) matrix."""
    return np.triu(np.full((n, n), Q - 1, np.int64))


CASES = ([("random", n) for n in (1, 3, 16)]
         + [("all q-1", n) for n in (1, 5)])


@pytest.mark.parametrize("what,n", CASES)
def test_gauss_inverse_and_solve_match_reference(what, n):
    rng = np.random.default_rng(n)
    a = (FERMAT.rand((n, n), rng) if what == "random"
         else _nonsingular_all_minus_one(n))
    b = FERMAT.rand((n, 5), rng) if what == "random" else np.full((n, 5), Q - 1)
    ref = _np(jsolve.gf_gauss_inverse(a))
    got = gf_gauss_inverse(a, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert np.array_equal(_np(got), ref)
    assert np.array_equal(ref, gauss_inverse(FERMAT, a))
    x = gf_solve(a, b, device="cpu")
    assert x.dtype == torch.int32
    assert np.array_equal(_np(x), _np(jsolve.gf_solve(a, b)))


@pytest.mark.parametrize("n", [40, 64])
def test_gauss_inverse_matches_host_oracle_at_larger_n(n):
    """Beyond the sizes the JAX eager loop runs quickly: the numpy oracle
    (which the JAX package's own tests hold its inverse against)."""
    rng = np.random.default_rng(n)
    a = FERMAT.rand((n, n), rng)
    ref = gauss_inverse(FERMAT, a)
    assert np.array_equal(_np(gf_gauss_inverse(a, device="cpu")), ref)
    b = FERMAT.rand((n, 130), rng)
    assert np.array_equal(_np(gf_solve(a, b, device="cpu")),
                          FERMAT.matmul(ref, b))


def test_solve_reduces_unreduced_inputs_like_reference():
    """Inputs outside [0, q) (negative, >= q) are reduced in int64 first."""
    rng = np.random.default_rng(7)
    a = rng.integers(-3 * Q, 3 * Q, (6, 6))
    b = rng.integers(-(1 << 40), 1 << 40, (6, 9))
    assert np.array_equal(_np(gf_solve(a, b, device="cpu")),
                          _np(jsolve.gf_solve(a, b)))


SINGULAR = {
    "row2 = 2 row1": np.array([[1, 2, 3], [2, 4, 6], [0, 0, 5]]),
    "zero": np.zeros((4, 4), np.int64),
    "zero first column": np.array([[0, 1], [0, 3]]),
    "all q-1": np.full((3, 3), Q - 1),
    "q multiples": np.array([[Q, 2], [2 * Q, 5]]),
    "dependent late column": np.array([[1, 0, 1], [0, 1, 1], [0, 0, 0]]),
}


@pytest.mark.parametrize("name", sorted(SINGULAR))
def test_singular_raises_same_value_error(name):
    a = SINGULAR[name]
    with pytest.raises(ValueError, match="singular") as jerr:
        jsolve.gf_gauss_inverse(a)
    with pytest.raises(ValueError, match="singular") as terr:
        gf_gauss_inverse(a, device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="singular"):
        gf_solve(a, np.ones((a.shape[0], 2), np.int64), device="cpu")


@pytest.mark.parametrize("values", [
    [-1, -2, -Q, -Q - 5, -(1 << 40)],
    [Q, Q + 1, 2 * Q - 1, 65536, 1 << 40, (1 << 62) + 3],
    [0, 1, 65535, 65536],
])
def test_as_field_u32_reduces_before_narrowing(values):
    ref = _np(jsolve._as_field_u32(np.array(values, np.int64)))
    got = tsolve._as_field_u32(np.array(values, np.int64), "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), ref)
    assert np.array_equal(ref, np.array(values, np.int64) % Q)
    # a torch tensor takes the same route
    got_t = tsolve._as_field_u32(torch.tensor(values, dtype=torch.int64), "cpu")
    assert np.array_equal(_np(got_t), ref)


def _codeword(jgrs, x):
    A = jgrs.grs.A_direct()
    return np.concatenate([x, FERMAT.matmul(A.T, x)])


@pytest.mark.parametrize("kept", list(itertools.combinations(range(6), 4)))
def test_reconstruct_every_kept_set_rs_4_2(kept):
    jg, tg = JGRS.build(FERMAT, 4, 2), TGRS.build(TFERMAT, 4, 2)
    x = FERMAT.rand((4, 7), np.random.default_rng(sum(kept)))
    full = _codeword(jg, x)
    kept = np.array(kept)
    ref = j_reconstruct(FERMAT, jg, kept, full[kept])
    got = t_reconstruct(TFERMAT, tg, kept, full[kept], device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, ref) and np.array_equal(got, x)


@pytest.mark.parametrize("lagrange", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_reconstruct_random_kept_sets_16_4(lagrange, seed):
    K, R = 16, 4
    jg = JGRS.build(FERMAT, K, R, lagrange=lagrange)
    tg = TGRS.build(TFERMAT, K, R, lagrange=lagrange)
    rng = np.random.default_rng(100 + seed)
    x = FERMAT.rand((K, 11), rng)
    full = _codeword(jg, x)
    kept = np.sort(rng.choice(K + R, K, replace=False))
    ref = j_reconstruct(FERMAT, jg, kept, full[kept])
    got = t_reconstruct(TFERMAT, tg, kept, full[kept], device="cpu")
    assert np.array_equal(got, ref) and np.array_equal(got, x)


def test_reconstruct_non_fermat_field_stays_on_host():
    jf, tf = Field(97), TField(97)
    jg, tg = JGRS.build(jf, 4, 4), TGRS.build(tf, 4, 4)
    rng = np.random.default_rng(5)
    x = jf.rand((4, 6), rng)
    full = np.concatenate([x, jf.matmul(jg.grs.A_direct().T, x)])
    kept = np.array([1, 2, 5, 7])
    ref = j_reconstruct(jf, jg, kept, full[kept])
    # host path: no device is resolved, so no card is needed either way
    got = t_reconstruct(tf, tg, kept, full[kept])
    assert np.array_equal(got, ref) and np.array_equal(got, x)


def test_solve_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    a = np.eye(3, dtype=np.int64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gf_solve(a, a)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gf_gauss_inverse(a)
    tg = TGRS.build(TFERMAT, 4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_reconstruct(TFERMAT, tg, np.arange(4), np.zeros((4, 2), np.int64))
