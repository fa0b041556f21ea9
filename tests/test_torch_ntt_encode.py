"""The port's NTT fast-path encode against the JAX package's, bitwise: the
host constants (`NTTEncodeParams`) element by element, and `ntt_encode` on
the same seeded payloads (the port on the CPU runs the NTT's plain
version; the JAX package runs its fused-XLA NTT there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import CodeSpec as JSpec
from repro.api.planner import _host_tables as jax_host_tables
from repro.core.field import FERMAT, FERMAT_Q
from repro.kernels.ntt_encode import ntt_encode as jax_ntt_encode
from repro_torch.api import CodeSpec as TSpec
from repro_torch.api.planner import _host_tables as torch_host_tables
from repro_torch.kernels.ntt_encode import ntt_encode

torch.set_num_threads(1)

SPECS = [("rs", 16, 4), ("rs", 64, 16), ("lagrange", 4, 8), ("lagrange", 8, 8),
         ("lagrange", 4, 16), ("dft", 16, 16)]


def _params(kind, K, R):
    jp = jax_host_tables(JSpec(kind=kind, K=K, R=R), None, None).ntt_params()
    tp = torch_host_tables(TSpec(kind=kind, K=K, R=R), None, None).ntt_params()
    return jp, tp


@pytest.mark.parametrize("kind,K,R", SPECS)
def test_params_match_reference(kind, K, R):
    jp, tp = _params(kind, K, R)
    assert jp is not None and tp is not None
    for name in ("kind", "K", "R", "Z", "M", "case_kge"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("phi_inv", "psi", "twist"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, b), name


def test_params_absent_where_reference_has_none():
    """K = 24 is no power of two: both packages fall back to the dense path."""
    assert _params("rs", 24, 6) == (None, None)


@pytest.mark.parametrize("kind,K,R", SPECS)
def test_ntt_encode_matches_reference(kind, K, R):
    jp, tp = _params(kind, K, R)
    x = np.random.default_rng(K * 31 + R).integers(0, FERMAT_Q, (K, 37))
    want = np.asarray(jax_ntt_encode(jnp.asarray(x, jnp.uint32), jp), np.int64)
    got = ntt_encode(torch.as_tensor(x.astype(np.int32)), tp)
    assert got.dtype == torch.int32 and got.shape == (R, 37)
    assert np.array_equal(got.numpy().astype(np.int64), want)
    # and both equal the dense encode x^T A with the spec's generator block
    A = torch_host_tables(TSpec(kind=kind, K=K, R=R), None, None).A
    assert np.array_equal(want, FERMAT.matmul(A.T, x))
