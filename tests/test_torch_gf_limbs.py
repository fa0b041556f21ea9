"""The limb arithmetic of the tensor-core `gf_matmul` kernel, on the CPU.

The kernel (`repro_torch/csrc/gf_matmul.cu`) splits a with the wrapper's
`a_limbs` and b while staging it into 8-bit limbs, sums limb products in
three s32 accumulators by weight mod q, and reduces them every 16,384 of K.
`_limb_matmul` repeats that scheme with int64 `torch.matmul` and checks the
s32 range at every flush; it is held bitwise (tolerance 0: field arithmetic
is exact) against `gf_matmul_plain` and the JAX package's Pallas kernel in
interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.field import FERMAT, FERMAT_Q
from repro.kernels.gf_matmul import gf_matmul as jax_gf_matmul
from repro_torch.kernels import gf_matmul_plain
from repro_torch.kernels.gf_matmul import a_limbs

torch.set_num_threads(1)

FLUSH = 16384      # k terms between the kernel's reductions mod q
S32 = 1 << 31


def _b_limbs(b):
    """The kernel's split of the payload: b = b0 + 2^8 b1 + 2^16 b2."""
    return b & 0xFF, (b >> 8) & 0xFF, b >> 16


def _limb_matmul(a, b, flush=FLUSH):
    """(a @ b) mod q by the kernel's limb scheme: S0 (weight 1), S8
    (weight 2^8) and S16 (weight 2^16 == -1), each an exact s32 sum over at
    most `flush` terms of k."""
    M, K = a.shape
    planes = a_limbs(a).long()[:, :, :K]
    assert planes.shape == (3, M, K) and int(planes[2].max()) <= 1
    b = b.long()
    c = torch.zeros((M, b.shape[1]), dtype=torch.int64)
    for k0 in range(0, K, flush):
        a0, a1, a2 = planes[:, :, k0:k0 + flush]
        b0, b1, b2 = _b_limbs(b[k0:k0 + flush])
        s0 = a0 @ b0 + a2 @ b2
        s8 = a0 @ b1 + a1 @ b0 - a2 @ b1 - a1 @ b2
        s16 = a1 @ b1 + a2 @ b0 + a0 @ b2
        for s in (s0, s8, s16):
            assert int(s.min()) >= -S32 and int(s.max()) < S32
        c = (c + s0 + 256 * s8 - s16) % FERMAT_Q
    return c


def _operands(M, K, N, corner, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, FERMAT_Q, (M, K))
    b = rng.integers(0, FERMAT_Q, (K, N))
    if corner in ("a", "both"):
        a.flat[rng.choice(a.size, max(1, a.size // 5), replace=False)] = FERMAT_Q - 1
    if corner in ("b", "both"):
        b.flat[rng.choice(b.size, max(1, b.size // 5), replace=False)] = FERMAT_Q - 1
    if corner == "max":  # a0 = a1 = b0 = b1 = 255: S8's largest step
        a[:], b[:] = 65535, 65535
    if corner == "all":
        a[:], b[:] = FERMAT_Q - 1, FERMAT_Q - 1
    return a, b


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64).astype(np.int32))


@pytest.mark.parametrize("M,K,N,corner", [
    (4, 64, 4, "none"), (4, 64, 4, "a"), (4, 64, 4, "b"), (4, 64, 4, "both"),
    (33, 70, 129, "both"), (3, 300, 65, "a"), (65, 33, 7, "b"),
    (2, 16383, 3, "both"), (3, 16384, 4, "max"), (4, 16385, 2, "both"),
    (2, 16385, 3, "max"), (3, 16385, 1, "all"),
])
def test_limb_scheme_matches_plain_and_reference(M, K, N, corner):
    a, b = _operands(M, K, N, corner, seed=M * 31 + K + N)
    want = FERMAT.matmul(a, b)
    got = _limb_matmul(_t(a), _t(b))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(gf_matmul_plain(_t(a), _t(b)).numpy(), want)
    ref = jax_gf_matmul(jnp.asarray(a, jnp.uint32), jnp.asarray(b, jnp.uint32),
                        interpret=True)
    assert np.array_equal(np.asarray(ref, np.int64), want)


@pytest.mark.parametrize("K,fits", [(16384, True), (16512, True), (16513, False)])
def test_limb_flush_interval_is_the_s32_limit(K, fits):
    """All-65535 operands make S8 grow by 2 * 255^2 per k: up to 16,512
    terms fit in s32, 16,513 do not, so the kernel's flush every 16,384 (64
    staged chunks of 256) is inside the limit."""
    a, b = _operands(1, K, 1, "max", seed=0)
    if fits:
        assert np.array_equal(_limb_matmul(_t(a), _t(b), flush=K).numpy(),
                              FERMAT.matmul(a, b))
    else:
        with pytest.raises(AssertionError):
            _limb_matmul(_t(a), _t(b), flush=K)


@pytest.mark.parametrize("K,Kp", [(17, 32), (0, 16)])
@pytest.mark.parametrize("value", [0, 1, 255, 256, 65535, 65536])
def test_a_limbs_recombine(value, K, Kp):
    a = torch.full((3, K), value, dtype=torch.int32)
    planes = a_limbs(a)
    assert planes.dtype == torch.uint8 and planes.shape == (3, 3, Kp)
    assert not planes[:, :, K:].any()  # the pad to 16 bytes is zero
    p = planes.long()
    assert torch.equal((p[0] + 256 * p[1] + 65536 * p[2])[:, :K], a.long())
