"""The port's kernel layer against the JAX package's, bitwise.

On the CPU the port's wrappers run their plain versions; these are held
against the Pallas kernels in interpret mode, the fused-XLA NTT and the
exact oracles.  Field arithmetic is exact, so every comparison is equality
(tolerance 0).  The CUDA kernels themselves are held against the plain
versions in `test_torch_cuda.py`, which needs a card and no JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as jfield
from repro.core.field import FERMAT, FERMAT_Q
from repro.kernels import ops as jops
from repro.kernels.gf_matmul import gf_matmul as jax_gf_matmul
from repro.kernels.ntt import ntt as jax_ntt
from repro.kernels.ntt import ntt_ref as jax_ntt_ref
from repro.kernels.ntt import ntt_twiddles as jax_ntt_twiddles
from repro.kernels.ntt import ntt_xla as jax_ntt_xla
from repro.kernels.ref import gf_matmul_ref as jax_gf_matmul_ref
from repro_torch.core import field as tfield
from repro_torch.kernels import (gf_matmul, gf_matmul_plain, ntt, ntt_plain,
                                 ntt_twiddles)
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32))


def _np(t):
    return np.asarray(t.numpy(), np.int64)


def _jnp(a):
    return np.asarray(a, np.int64)


def _oracle(a, b):
    return FERMAT.matmul(a.astype(np.int64), b.astype(np.int64))


# ---------------- field arithmetic (int64 torch vs uint32 jnp) --------------

@pytest.mark.parametrize("name", ["fermat_mul", "fermat_add", "fermat_sub"])
def test_fermat_ops_match_reference(name):
    rng = _rng(1)
    a = rng.integers(0, FERMAT_Q, 4096)
    b = rng.integers(0, FERMAT_Q, 4096)
    a[:4], b[:4] = [65536, 65536, 0, 65536], [65536, 0, 65536, 1]
    want = _jnp(getattr(jfield, name)(jnp.asarray(a, jnp.uint32),
                                      jnp.asarray(b, jnp.uint32)))
    got = _np(getattr(tfield, name)(torch.as_tensor(a), torch.as_tensor(b)))
    assert np.array_equal(got, want)


def test_fermat_reduce_and_matvec_match_reference():
    rng = _rng(2)
    x = rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
    assert np.array_equal(
        _np(tfield.fermat_reduce(torch.as_tensor(x.astype(np.int64)))),
        _jnp(jfield.fermat_reduce(jnp.asarray(x, jnp.uint32))))
    v = rng.integers(0, FERMAT_Q, (5, 33))
    c = rng.integers(0, FERMAT_Q, (33, 7))
    want = _jnp(jfield.fermat_matvec_cols(jnp.asarray(v, jnp.uint32),
                                          jnp.asarray(c, jnp.uint32)))
    got = _np(tfield.fermat_matvec_cols(torch.as_tensor(v), torch.as_tensor(c)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _oracle(v, c))


# ---------------- gf_matmul ----------------------------------------------------

@pytest.mark.parametrize(
    "M,K,N",
    [(1, 1, 1), (128, 128, 128), (7, 300, 65), (130, 257, 96),
     (200, 130, 250), (128, 1, 128), (1, 1024, 1)],
)
def test_gf_matmul_shape_sweep(M, K, N):
    rng = _rng(M * 7 + K * 3 + N)
    a = rng.integers(0, FERMAT_Q, (M, K))
    b = rng.integers(0, FERMAT_Q, (K, N))
    want = _jnp(jax_gf_matmul(jnp.asarray(a, jnp.uint32),
                              jnp.asarray(b, jnp.uint32), interpret=True))
    assert np.array_equal(want, _oracle(a, b))
    assert np.array_equal(_jnp(jax_gf_matmul_ref(jnp.asarray(a, jnp.uint32),
                                                 jnp.asarray(b, jnp.uint32))),
                          want)
    got = gf_matmul(_t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), want)
    assert np.array_equal(_np(gf_matmul_plain(_t(a), _t(b))), want)


@pytest.mark.parametrize("shape", [(64, 64), (130, 64)])
def test_gf_matmul_65536_corner(shape):
    """65536 == -1 (mod q) is the TPU kernel's only uint32-overflow corner."""
    a = np.full(shape, 65536)
    b = np.full((shape[1], 32), 65536)
    want = _jnp(jax_gf_matmul(jnp.asarray(a, jnp.uint32),
                              jnp.asarray(b, jnp.uint32), interpret=True))
    assert np.array_equal(_np(gf_matmul(_t(a), _t(b))), want)


def test_gf_matmul_worst_case_accumulation():
    """All-max values over a deep reduction (K = 4096: 32 of the TPU
    kernel's bk = 128 grid steps)."""
    a = np.full((8, 4096), FERMAT_Q - 1)
    b = np.full((4096, 8), FERMAT_Q - 1)
    aj, bj = jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32)
    want = _jnp(jax_gf_matmul(aj, bj, interpret=True))
    assert np.array_equal(want, _oracle(a, b))
    assert np.array_equal(_jnp(jax_gf_matmul_ref(aj, bj)), want)
    assert np.array_equal(_np(gf_matmul(_t(a), _t(b))), want)


def test_gf_matmul_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gf_matmul(a, torch.zeros((5, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        gf_matmul(a.long(), torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        gf_matmul(a[0], torch.zeros((4, 2), dtype=torch.int32))


# ---------------- NTT ----------------------------------------------------------

@pytest.mark.parametrize("Z", [2, 4, 16, 64, 256, 1024])
def test_ntt_twiddles_match_reference(Z):
    for inverse in (False, True):
        assert np.array_equal(ntt_twiddles(Z, inverse), jax_ntt_twiddles(Z, inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("Z", [2, 4, 16, 64, 256, 1024])
def test_ntt_matches_reference(Z, inverse):
    x = _rng(Z).integers(0, FERMAT_Q, (Z, 6))
    xj = jnp.asarray(x, jnp.uint32)
    want = _jnp(jax_ntt(xj, inverse=inverse, interpret=True))
    assert np.array_equal(_jnp(jax_ntt_xla(xj, inverse=inverse)), want)
    if Z <= 256:  # the oracle inverts the (Z, Z) DFT matrix on the host
        assert np.array_equal(_jnp(jax_ntt_ref(xj, inverse=inverse)), want)
    got = ntt(_t(x), inverse=inverse)
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("Z", [16, 128])
def test_ntt_ragged_width_and_roundtrip(Z):
    x = _rng(Z + 1).integers(0, FERMAT_Q, (Z, 131))  # 131 % 128 != 0
    y = ntt(_t(x))
    assert np.array_equal(_np(y), _jnp(jax_ntt(jnp.asarray(x, jnp.uint32),
                                               interpret=True)))
    assert np.array_equal(_np(ntt(y, inverse=True)), x)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_all_65536(inverse):
    x = np.full((64, 4), FERMAT_Q - 1)
    xj = jnp.asarray(x, jnp.uint32)
    want = _jnp(jax_ntt(xj, inverse=inverse, interpret=True))
    assert np.array_equal(_jnp(jax_ntt_ref(xj, inverse=inverse)), want)
    assert np.array_equal(_np(ntt(_t(x), inverse=inverse)), want)
    assert np.array_equal(_np(ntt_plain(_t(x), inverse=inverse)), want)


@pytest.mark.parametrize("Z,C", [(8192, 3), (8192, 131), (65536, 3)])
def test_ntt_above_4096_matches_reference(Z, C):
    """The JAX package answers every Z dividing q - 1; so does the port."""
    x = _rng(Z + C).integers(0, FERMAT_Q, (Z, C))
    x[:, 0] = FERMAT_Q - 1  # one all-65536 column
    xj = jnp.asarray(x, jnp.uint32)
    for inverse in (False, True):
        want = _jnp(jax_ntt_xla(xj, inverse=inverse))
        assert np.array_equal(_jnp(jax_ntt(xj, inverse=inverse, interpret=True)),
                              want)
        got = ntt(_t(x), inverse=inverse)
        assert got.dtype == torch.int32
        assert np.array_equal(_np(got), want)
    assert np.array_equal(_np(ntt(ntt(_t(x)), inverse=True)), x)


def test_ntt_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ntt(torch.zeros((12, 3), dtype=torch.int32))        # not 2^h
    with pytest.raises(ValueError):
        ntt(torch.zeros((1 << 17, 1), dtype=torch.int32))   # 2^17 does not divide q - 1
    with pytest.raises(TypeError):
        ntt(torch.zeros((8, 3), dtype=torch.int64))


# ---------------- encode_blocks / decode_blocks across the old threshold ----

@pytest.mark.parametrize("S,T,W", [(160, 130, 200), (4, 3, 200), (130, 4, 128)])
def test_encode_decode_blocks_match_reference(S, T, W):
    rng = _rng(S + T + W)
    x = rng.integers(0, FERMAT_Q, (S, W))
    coeffs = rng.integers(0, FERMAT_Q, (S, T))
    want = _jnp(jops.encode_blocks(jnp.asarray(x, jnp.uint32),
                                   jnp.asarray(coeffs, jnp.uint32)))
    assert np.array_equal(want, _oracle(coeffs.T, x))
    assert np.array_equal(_np(tops.encode_blocks(_t(x), _t(coeffs))), want)
    want_d = _jnp(jops.decode_blocks(jnp.asarray(x, jnp.uint32),
                                     jnp.asarray(coeffs, jnp.uint32)))
    assert np.array_equal(_np(tops.decode_blocks(_t(x), _t(coeffs))), want_d)
