"""`gf_matmul_batched`'s dispatch between its two designs, on the CPU: the
rule at the mesh's combine shapes and the sweep's, the private `_design`
keyword, and the plain version for CPU tensors whatever design is asked
for.  The kernels themselves run on the card (`tests/test_torch_cuda.py`);
the plain version is held against the JAX package's `gf_matmul_ref`, the
reference's combine (`repro/core/shardmap_exec.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gf_matmul_ref
from repro_torch.kernels import gf_matmul_batched, gf_matmul_batched_plain
from repro_torch.kernels.gf_matmul import _batched_design

torch.set_num_threads(1)

Q = 65537


@pytest.mark.parametrize("M,K,design", [
    (3, 2, "small"), (5, 4, "small"), (9, 8, "small"),   # rs 16/4 .. 256/64
    (17, 16, "small"), (33, 32, "imma"),                 # the deeper sweep
    (64, 256, "imma"), (1, 1, "small"), (1, 32, "small"), (64, 32, "imma"),
    (65, 1, "imma"), (2, 33, "imma"), (4, 0, "small")])
def test_batched_design_rule(M, K, design):
    assert _batched_design(M, K) == design


def test_batched_design_rule_follows_the_counts():
    """Small only inside its kernel's limits, and there exactly while
    M K <= 10 (M + K): multiply-adds a column against its bytes / 4."""
    for M in range(1, 80):
        for K in range(0, 40):
            small = M <= 64 and K <= 32 and M * K <= 10 * (M + K)
            assert (_batched_design(M, K) == "small") == small, (M, K)


@pytest.mark.parametrize("design", ["tensor", "SMALL", "", "plain"])
def test_batched_refuses_an_unknown_design(design):
    a = torch.zeros((2, 3, 4), dtype=torch.int32)
    b = torch.zeros((2, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown design"):
        gf_matmul_batched(a, b, _design=design)


@pytest.mark.parametrize("design", [None, "small", "imma"])
@pytest.mark.parametrize("B,M,K,N", [(16, 3, 2, 33), (4, 9, 8, 7),
                                     (2, 33, 32, 5), (2, 5, 40, 9)])
def test_batched_cpu_runs_the_plain_version_whatever_the_design(design, B, M,
                                                                K, N):
    rng = np.random.default_rng(B + M + K + N)
    a = rng.integers(0, Q, (B, M, K))
    b = rng.integers(0, Q, (B, K, N))
    a[0, 0, 0] = b[-1, -1, -1] = Q - 1
    ta = torch.as_tensor(a.astype(np.int32))
    tb = torch.as_tensor(b.astype(np.int32))
    before = gf_matmul_batched.launches
    by_design = dict(gf_matmul_batched.launches_by_design)
    got = gf_matmul_batched(ta, tb, _design=design)
    assert got.dtype == torch.int32 and got.shape == (B, M, N)
    assert gf_matmul_batched.launches == before
    assert gf_matmul_batched.launches_by_design == by_design
    want = np.stack([np.asarray(gf_matmul_ref(jnp.asarray(a[z], jnp.uint32),
                                              jnp.asarray(b[z], jnp.uint32)))
                     for z in range(B)]).astype(np.int64)
    assert np.array_equal(got.long().numpy(), want)
    assert torch.equal(gf_matmul_batched_plain(ta, tb), got.long())


def test_batched_counts_both_designs_from_zero():
    assert set(gf_matmul_batched.launches_by_design) == {"small", "imma"}
