"""The schemes of the three NTT kernels, on the CPU.

`csrc/ntt.cu` runs a Z <= 64 transform as one pure DIF over the powers of
the root (`ntt_regs`), and a Z-point DIF transform with Z > 64 as a pure
Z1-point DIF of each strided sequence x[j + a Z2], a twist by
root^(j rev(a)), and a pure Z2-point DIF of each contiguous block of Z2 rows
(`ntt_slab`, Z <= 4096); above 4096 the leading-stages kernel (`ntt_outer`)
does the first split with Z2 = 4096 and `ntt_slab` finishes each block.
`_split_ntt` repeats that scheme in int64 torch with the wrapper's own host
tables (`slab_tables`, `outer_tables`, `roots`) and is held bitwise
(tolerance 0: field arithmetic is exact) against `ntt_plain` and the JAX
package's `ntt_xla`.  The CUDA kernels themselves are held against
`ntt_plain` on the card (`test_torch_cuda.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ntt import ntt_twiddles as jax_ntt_twiddles
from repro.kernels.ntt import ntt_xla as jax_ntt_xla
from repro_torch.core.field import FERMAT, FERMAT_Q, fermat_add, fermat_mul, fermat_sub
from repro_torch.kernels import ntt_plain, ntt_twiddles
from repro_torch.kernels.ntt import (REGS_MAX_Z, SLAB_MAX_Z, outer_tables,
                                     regs_tables, roots, slab_split,
                                     slab_tables)

torch.set_num_threads(1)


def _dif(v, tw, inverse):
    """Pure DIF (or its stagewise inverse) along axis 0 of v (N, ...), as the
    kernels' `dif`: stage h pairs rows u, u + half with tw[(u mod half) << h]."""
    N = v.shape[0]
    L = N.bit_length() - 1
    rest = v.shape[1:]
    v = v.reshape(N, -1)
    for h in (range(L - 1, -1, -1) if inverse else range(L)):
        half = N >> (h + 1)
        vr = v.reshape(N // (2 * half), 2, half, -1)
        u, w = vr[:, 0], vr[:, 1]
        t = torch.as_tensor(tw[np.arange(half) << h].astype(np.int64))[None, :, None]
        if inverse:
            m = fermat_mul(w, t)
            s, d = fermat_add(u, m), fermat_sub(u, m)
        else:
            s, d = fermat_add(u, w), fermat_mul(fermat_sub(u, w), t)
        v = torch.stack([s, d], dim=1).reshape(N, -1)
    return v.reshape(N, *rest)


def _twisted_split(x, z1, w1, twist, w2, inverse):
    """x (B, z1 * z2, C): pass A (pure z1-point DIF over a of x[a z2 + j]),
    the (z1, z2) twist, pass B (pure z2-point DIF of each block a); the
    inverse runs the three steps backwards."""
    B, Z, C = x.shape
    z2 = Z // z1
    v = x.reshape(B, z1, z2, C).permute(1, 0, 2, 3)  # [a, b, j, c]
    tw = torch.as_tensor(twist.astype(np.int64))[:, None, :, None]
    if inverse:
        v = _dif(v.permute(2, 1, 0, 3), w2, True).permute(2, 1, 0, 3)
        v = _dif(fermat_mul(v, tw), w1, True)
    else:
        v = fermat_mul(_dif(v, w1, False), tw)
        v = _dif(v.permute(2, 1, 0, 3), w2, False).permute(2, 1, 0, 3)
    return v.permute(1, 0, 2, 3).reshape(B, Z, C)


def _slab(x, Z, root, scale, inverse):
    z1, z2 = slab_split(Z)
    tw, twist = slab_tables(Z, root, scale)
    assert twist.shape == (z1, z2) and z1 <= 64 and z2 <= 64
    return _twisted_split(x, z1, tw[:z1 // 2], twist, tw[32:32 + z2 // 2], inverse)


def _outer_only(x, z0, tw, twist, inverse):
    """ntt_outer: pure z0-point DIF of each x[j + a 4096], with the twist
    after it (forward) or before it (inverse, Z^-1 folded into the table)."""
    Z, C = x.shape
    v = x.reshape(z0, SLAB_MAX_Z, C)
    t = torch.as_tensor(twist.astype(np.int64))[:, :, None]
    if inverse:
        return _dif(fermat_mul(v, t), tw, True).reshape(Z, C)
    return fermat_mul(_dif(v, tw, False), t).reshape(Z, C)


def _split_ntt(x, inverse):
    """The kernels' route for every Z (the wrapper's `_run`)."""
    Z, C = x.shape
    root, scale = roots(Z, inverse)
    if Z <= REGS_MAX_Z:
        y = _dif(x, regs_tables(Z, root), inverse)
        return fermat_mul(y, torch.tensor(scale)) if inverse else y
    if Z <= SLAB_MAX_Z:
        return _slab(x[None], Z, root, scale, inverse)[0]
    z0 = Z // SLAB_MAX_Z
    sub = pow(root, z0, FERMAT_Q)
    tw, twist = outer_tables(Z, root, scale)

    def slabs(v):
        return _slab(v.reshape(z0, SLAB_MAX_Z, C), SLAB_MAX_Z, sub, 1,
                     inverse).reshape(Z, C)

    if inverse:  # the 4096-point inverses (scale 1), then the leading stages
        return _outer_only(slabs(x), z0, tw, twist, True)
    return slabs(_outer_only(x, z0, tw, twist, False))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("Z", [1 << h for h in range(17)])
def test_split_matches_plain(Z, inverse):
    rng = np.random.default_rng(Z + inverse)
    x = torch.as_tensor(rng.integers(0, FERMAT_Q, (Z, 3)))
    x[:, 0] = FERMAT_Q - 1  # an all-65536 column
    assert torch.equal(_split_ntt(x, inverse), ntt_plain(x, inverse=inverse))


@pytest.mark.parametrize("Z", [128, 2048, 8192])
def test_split_matches_reference(Z):
    x = np.random.default_rng(Z).integers(0, FERMAT_Q, (Z, 5))
    xj = jnp.asarray(x, jnp.uint32)
    for inverse in (False, True):
        want = np.asarray(jax_ntt_xla(xj, inverse=inverse), np.int64)
        assert np.array_equal(_split_ntt(torch.as_tensor(x), inverse).numpy(), want)


def test_twiddles_nest_and_tables_hold_roots():
    """The facts the split rests on: a Z-point DIF's stages h >= 1 use the
    Z/2-point twiddles tiled twice (so root_Z^(Z/4096) is the 4096-point
    root); the inverse's root and Z^-1 invert the forward's; the twist's
    row a = 0 is the bare scale and each pass's first twiddle is 1."""
    for Z in (128, 8192, 1 << 16):
        big, small = ntt_twiddles(Z), ntt_twiddles(Z // 2)
        assert np.array_equal(big, jax_ntt_twiddles(Z))
        for h in range(1, big.shape[0]):
            assert np.array_equal(big[h], np.tile(small[h - 1], 2))
    for Z in (8192, 1 << 16):
        assert pow(FERMAT.root_of_unity(Z), Z // SLAB_MAX_Z, FERMAT_Q) == \
            FERMAT.root_of_unity(SLAB_MAX_Z)
    root, scale = roots(4096, True)
    assert root * FERMAT.root_of_unity(4096) % FERMAT_Q == 1
    assert scale * 4096 % FERMAT_Q == 1
    tw, twist = slab_tables(4096, root, scale)
    assert twist[0].tolist() == [scale] * 64  # rev(0) = 0: the bare scale
    assert int(tw[0]) == int(tw[32]) == 1


@pytest.mark.parametrize("Z", [1 << h for h in range(17)])
def test_tables_fit_32_bit_products(Z):
    """The kernels multiply by stage twiddles and forward twist factors with
    32-bit products (`mulmod_tw`), exact only for factors other than 65536;
    the inverse twist (Z^-1 folded in) takes the 64-bit product."""
    for inverse in (False, True):
        root, scale = roots(Z, inverse)
        if Z <= REGS_MAX_Z:
            assert (regs_tables(Z, root) < FERMAT_Q - 1).all()
            continue
        if Z <= SLAB_MAX_Z:
            z1, z2 = slab_split(Z)
            tw, twist = slab_tables(Z, root, scale)
            stage = [tw[:z1 // 2], tw[32:32 + z2 // 2]]
        else:
            z0 = Z // SLAB_MAX_Z
            tw, twist = outer_tables(Z, root, scale)
            sub, _ = slab_tables(SLAB_MAX_Z, pow(root, z0, FERMAT_Q), 1)
            stage = [tw, sub[:32], sub[32:]]
        for t in stage:
            assert (t < FERMAT_Q - 1).all()
        assert (twist < FERMAT_Q).all()
        if not inverse:
            assert (twist < FERMAT_Q - 1).all()

