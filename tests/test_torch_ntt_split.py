"""The schemes of the NTT kernels, on the CPU.

`csrc/ntt.cu` runs a Z <= 64 transform as one pure DIF over the powers of
the root (`ntt_regs`), and a Z-point DIF transform with Z > 64 as a pure
Z1-point DIF of each strided sequence x[j + a Z2], a twist by
root^(j rev(a)), and a pure Z2-point DIF of each contiguous block of Z2 rows
(`ntt_slab`, Z <= 4096).  Above 4096 the one-pass cluster kernel
(`ntt_cluster`, the main path) splits Z into Z / rows blocks of
rows = `CLUSTER_ROWS[Z]` rows (2048 up to 2^15, 4096 at 2^16), each held by
one block of a cluster in shared memory, and exchanges the leading stages'
values through the cluster's shared memory; the forced two-pass route
splits it with Z2 = 4096 and runs the leading-stages kernel (`ntt_outer`),
then `ntt_slab` on each 4096-row block.  `_split_ntt` (the two-pass route) and `_cluster_ntt` (the cluster
kernel's data movement, word for word in its padded shared layout) repeat
those schemes in int64 torch with the wrapper's own host tables
(`slab_tables`, `outer_tables`, `cluster_tables`, `roots`) and are held
bitwise (tolerance 0: field arithmetic is exact) against `ntt_plain` and
the JAX package's `ntt_xla`.  The CUDA kernels themselves are held against
`ntt_plain` on the card (`test_torch_cuda.py`, `chip_smoke.py`).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ntt import ntt_twiddles as jax_ntt_twiddles
from repro.kernels.ntt import ntt_xla as jax_ntt_xla
from repro_torch.core.field import FERMAT, FERMAT_Q, fermat_add, fermat_mul, fermat_sub
from repro_torch.kernels import ntt, ntt_plain, ntt_twiddles
from repro_torch.kernels.ntt import (CLUSTER_ROWS, REGS_MAX_Z, ROUTES,
                                     SLAB_MAX_Z, cluster_tables, outer_tables,
                                     regs_tables, roots, slab_split, slab_tables)

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
    """The kernels' schemes for every Z, with the two-pass route above
    4096 (the wrapper's `_run` with `_route="two-pass"`)."""
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


BW = 8          # ntt_cluster's columns a cluster (CLUSTER_BW)
BLK = 65 * BW   # its shared words a padded block of 64 rows


def _exchange_slots(z0, rows):
    """The cluster kernel's exchange with `rows` rows a block (Z1 = rows /
    64 threads a column): (b, k, p) -> the word slot + (k Z1 / 64) BLK +
    (k Z1 % 64) BW (plus c) of every rank's shared array where block b's
    thread (p, c) puts or finds local row j = b rows / z0 + k Z1 + p of its
    k-th sequence, as the kernel computes it; and those j."""
    z1 = rows // 64
    b = torch.arange(z0)[:, None, None]
    k = torch.arange(64 // z0)[None, :, None]
    p = torch.arange(z1)[None, None, :]
    j = b * (rows // z0) + k * z1 + p
    slot = b * (z1 // z0) * BLK + p * BW
    return slot + (k * z1 // 64) * BLK + (k * z1 % 64) * BW, j


def _cluster_ntt(x, inverse):
    """The cluster kernel's data movement for Z = z0 rows (`CLUSTER_ROWS`):
    rank a's shared array holds rows [a rows, (a + 1) rows) of 8 columns in
    the padded layout (row a' 64 + j at word a' BLK + j BW + c; the pad
    word is never written and reads as -1 here); forward: each block's
    share of the sequences j loads x[j + a rows], runs the z0-point DIF and
    the twist and scatters value a to rank a; then each rank runs the slab
    (pass A, twist, pass B) on its array and stores its rows.  The inverse
    runs the steps backwards.  Ragged columns load as 0 and are not
    stored."""
    Z, C = x.shape
    rows = CLUSTER_ROWS[Z]
    z0, z1, bw, blk = Z // rows, rows // 64, BW, BLK
    root, scale = roots(Z, inverse)
    tw, otwist, stwist = cluster_tables(Z, root, scale)
    assert stwist.shape == (z1, 64)

    def slab(v, inv):  # pass A, twist, pass B of each rank's rows
        return _twisted_split(v, z1, tw[8:8 + z1 // 2], stwist, tw[40:], inv)
    groups = -(-C // bw)
    xg = torch.zeros((Z, groups * bw), dtype=torch.int64)
    xg[:, :C] = x
    xg = xg.reshape(Z, groups, bw)
    slot, j = _exchange_slots(z0, rows)               # [b, k, p]
    # [b, k, p, group, c] words of every rank; g [group, 1] the group
    words = (slot[..., None, None] + torch.arange(bw)).expand(-1, -1, -1, groups, -1)
    g = torch.arange(groups)[:, None]
    a = torch.arange(z0)[:, None, None, None]
    at = j[None] + a * rows                           # [a, b, k, p]
    t = torch.as_tensor(otwist.astype(np.int64))[a, j[None]][..., None, None]

    def rank_rows(sm):  # padded words -> (rank, rows, groups * bw)
        v = sm.reshape(z0, groups, z1, 65, bw)[:, :, :, :64]
        return v.permute(0, 2, 3, 1, 4).reshape(z0, rows, groups * bw)

    def to_words(v):  # the inverse of rank_rows
        v = v.reshape(z0, z1, 64, groups, bw).permute(0, 3, 1, 2, 4)
        sm = torch.full((z0, groups, z1, 65, bw), -1, dtype=torch.int64)
        sm[:, :, :, :64] = v
        return sm.reshape(z0, groups, z1 * blk)

    if not inverse:
        smem = torch.full((z0, groups, z1 * blk), -1, dtype=torch.int64)
        vals = _dif(xg[at], tw[:z0 // 2], False)        # [a, b, k, p, group, c]
        smem[:, g, words] = fermat_mul(vals, t)         # value a to rank a
        y = slab(rank_rows(smem), False)
        return y.reshape(Z, groups * bw)[:, :C]
    v = slab(xg.reshape(z0, rows, groups * bw), True)
    vals = to_words(v)[:, g, words]                     # [a, b, k, p, group, c]
    vals = _dif(fermat_mul(vals, t), tw[:z0 // 2], True)
    out = torch.zeros((Z, groups, bw), dtype=torch.int64)
    out[at] = vals
    return out.reshape(Z, groups * bw)[:, :C]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("Z", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_cluster_matches_plain(Z, inverse):
    """The one-pass cluster kernel's scheme at every Z it takes, over two
    clusters of columns (the second ragged), with an all-65536 column."""
    rng = np.random.default_rng(Z + 2 + inverse)
    x = torch.as_tensor(rng.integers(0, FERMAT_Q, (Z, 11)))
    x[:, 3] = FERMAT_Q - 1
    assert torch.equal(_cluster_ntt(x, inverse), ntt_plain(x, inverse=inverse))


@pytest.mark.parametrize("Z", [1 << 13, 1 << 14])
def test_cluster_matches_reference(Z):
    x = np.random.default_rng(Z + 5).integers(0, FERMAT_Q, (Z, 5))
    xj = jnp.asarray(x, jnp.uint32)
    for inverse in (False, True):
        want = np.asarray(jax_ntt_xla(xj, inverse=inverse), np.int64)
        assert np.array_equal(_cluster_ntt(torch.as_tensor(x), inverse).numpy(), want)


@pytest.mark.parametrize("Z", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_cluster_exchange_fills_every_row_once(Z):
    """The exchange's slots: over all blocks b, sequences k and threads p of
    a cluster, each of a rank's rows is written (forward) or read (inverse)
    exactly once, at its padded word, and block b's sequences are its own
    share of j; a cluster has at most 16 blocks."""
    rows = CLUSTER_ROWS[Z]
    z0 = Z // rows
    assert z0 <= 16 and rows // 64 >= z0
    slot, j = _exchange_slots(z0, rows)
    assert sorted(j.flatten().tolist()) == list(range(rows))
    assert torch.equal(slot, (j // 64) * BLK + (j % 64) * BW)
    share = rows // z0
    assert torch.equal(j // share, torch.arange(z0)[:, None, None].expand_as(j))


@pytest.mark.parametrize("Z", [64, 4096, 1 << 13, 1 << 16])
def test_private_route_leaves_cpu_result_unchanged(Z):
    """`_route` only forces a kernel route on the card; a CPU tensor runs
    the plain version whichever is named, and an unknown name raises."""
    x = torch.as_tensor(np.random.default_rng(Z).integers(0, FERMAT_Q, (Z, 3)),
                        dtype=torch.int32)
    for inverse in (False, True):
        want = ntt(x, inverse=inverse)
        assert torch.equal(want.long(), ntt_plain(x, inverse=inverse))
        for forced in ROUTES:
            assert torch.equal(ntt(x, inverse=inverse, _route=forced), want)
    for bad in ("one-pass", "Cluster", "outer", ""):
        with pytest.raises(ValueError, match="route"):
            ntt(x, _route=bad)


def test_route_dispatch(monkeypatch):
    """The wrapper's dispatch by Z alone, with the C entries replaced by
    recorders: registers up to 64, the slab up to 4096, above it one cluster
    launch in both directions (given log2 Z, C and the direction: the kernel
    sets its rows from log2 Z), and the two-pass route (leading stages and
    the slab over Z / 4096 blocks, the other way round for the inverse) only
    when `_route` forces it."""
    mod = importlib.import_module("repro_torch.kernels.ntt")
    calls = []

    def recorder(kernel, at):  # the C entry's (log2 Z or L0, C, batches?, inverse)
        return lambda *args: calls.append((kernel, *args[at:-1])) or 0

    monkeypatch.setattr(mod, "_regs_launcher", lambda: recorder("registers", 3))
    monkeypatch.setattr(mod, "_slab_launcher", lambda: recorder("slab", 4))
    monkeypatch.setattr(mod, "_outer_launcher", lambda: recorder("outer", 4))
    monkeypatch.setattr(mod, "_cluster_launcher", lambda: recorder("cluster", 5))
    monkeypatch.setattr(mod.ntt, "launches", 0)
    monkeypatch.setattr(mod.ntt, "launches_by_kernel", dict.fromkeys(
        ("registers", "slab", "cluster", "outer"), 0))
    assert set(CLUSTER_ROWS) == {1 << h for h in range(13, 17)}
    for h in range(17):
        Z = 1 << h
        x = torch.zeros((Z, 3), dtype=torch.int32)
        for inverse in (False, True):
            for forced in (None,) + ROUTES:
                calls.clear()
                mod._run(x, torch.empty_like(x), inverse, None, forced)
                i = int(inverse)
                if Z <= REGS_MAX_Z:
                    _, scale = roots(Z, inverse)
                    want = [("registers", h, 3, scale, i)]
                elif Z <= SLAB_MAX_Z:
                    want = [("slab", h, 3, 1, i)]
                elif forced != "two-pass":
                    want = [("cluster", h, 3, i)]
                else:
                    L0, z0 = h - 12, Z // SLAB_MAX_Z
                    want = [("outer", L0, 3, i), ("slab", 12, 3, z0, i)]
                    if inverse:
                        want.reverse()
                assert calls == want, (Z, inverse, forced)
    assert mod.ntt.launches == sum(mod.ntt.launches_by_kernel.values())


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
            sub, stwist = slab_tables(SLAB_MAX_Z, pow(root, z0, FERMAT_Q), 1)
            stage = [tw, sub[:32], sub[32:]]
            rows = CLUSTER_ROWS[Z]
            ctw, cotwist, cstwist = cluster_tables(Z, root, scale)
            if rows == SLAB_MAX_Z:
                # at 4096 rows the two-pass route's twiddles in one
                # parameter block, the slab's twist table with scale 1
                assert np.array_equal(ctw[:z0 // 2], tw) and not ctw[z0 // 2:8].any()
                assert np.array_equal(ctw[8:], sub)
                assert np.array_equal(cotwist, twist) and np.array_equal(cstwist, stwist)
            assert not ctw[Z // rows // 2:8].any() and cstwist.shape == (rows // 64, 64)
            stage += [ctw[:Z // rows // 2], ctw[8:40], ctw[40:], cstwist]
            assert (cotwist < FERMAT_Q).all()
            assert inverse or (cotwist < FERMAT_Q - 1).all()
        for t in stage:
            assert (t < FERMAT_Q - 1).all()
        assert (twist < FERMAT_Q).all()
        if not inverse:
            assert (twist < FERMAT_Q - 1).all()


def test_fold_of_32_bit_products():
    """The kernels' `mulmod_tw`: p = a w in uint32, r = p - (p >> 16) q, then
    min(r, r + q) (wrapping) equals a w mod q for every a < q and every
    factor w < q - 1, here each a against 256 factors (0, 1, q - 2 and
    seeded others)."""
    a = np.arange(FERMAT_Q, dtype=np.uint32)[:, None]
    w = np.concatenate([[0, 1, FERMAT_Q - 2],
                        np.random.default_rng(7).integers(2, FERMAT_Q - 2, 253)])
    w = w.astype(np.uint32)[None, :]
    p = a * w  # < 2^32: exact in uint32
    r = p - (p >> np.uint32(16)) * np.uint32(FERMAT_Q)
    got = np.minimum(r, r + np.uint32(FERMAT_Q))
    want = (a.astype(np.uint64) * w.astype(np.uint64)) % FERMAT_Q
    assert np.array_equal(got.astype(np.uint64), want)
