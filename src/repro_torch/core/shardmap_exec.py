"""Mesh execution of the paper's schedules: processors in blocks per rank.

The JAX package's `core/shardmap_exec.py` runs each of the paper's K
processors on one device of a mesh axis and each communication round as a
`jax.lax.ppermute`.  Here a *rank* (one process of a `torch.distributed`
group of world size G, or the only process when no group is initialised)
owns a contiguous block of K/G processors, held as one `(K/G, ...)` int32
tensor on the rank's device.  A round's permutation becomes an index copy
inside the block for every pair of processors on the same rank, and one
`batch_isend_irecv` per round for the pairs that cross ranks; a processor
that receives nothing gets zeros, as in `ppermute`.  On one card G = 1 and
every leg is a device-local index copy.

The host half — `_group_perm`, the slot map, the universal / DFT /
draw-and-loose table builders and the schedule-IR lowering
(`build_ir_mesh_program`) — is a copy of the JAX package's numpy code, so
the tables are equal array for array.  The bodies (`mesh_*`) take this
rank's `(K/G, W)` int32 block and its table rows, and return its block.

The per-processor combine of the universal all-to-all runs the `gf_matmul`
kernel's batched entry (`kernels.gf_matmul_batched`), one launch for all
K/G processors' `[coef; corr] (n_pad+1, m) . buf (m, W)`; the reference
runs its plain oracle there.  The arithmetic is exact mod q either way.
The other field operations are elementwise torch on int32 payloads,
products widened to int64 and reduced back.

A `TieredAxis` (a hosts x devices-per-host split of the K processors)
does not choose a mesh axis here: it classifies every leg as the
reference's `_tiered_ppermute` would lower it (a dev-axis leg, a host-axis
leg or a joint permute) and `ProcMesh.legs` counts the legs per tier.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from .field import FERMAT_Q
from .matrices import StructuredPoints, gauss_inverse, vandermonde
from .prepare_shoot import phase_split

Q = FERMAT_Q


# ---------------------------------------------------------------------------
# field operations on int32 payloads (values in [0, q))
# ---------------------------------------------------------------------------

def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b  # < 2q < 2^31
    return torch.where(s >= Q, s - Q, s)


def _sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + Q, d)


def _mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.long() * b.long()).remainder_(Q).int()


# ---------------------------------------------------------------------------
# grouped permutations
# ---------------------------------------------------------------------------

def _group_perm(N: int, stride: int, size: int, shift: int) -> list[tuple[int, int]]:
    """Cyclic shift by `shift` within groups of `size` members spaced
    `stride` apart (group of processor k: same k % stride ...
    k // (stride*size)).

    Covers columns (stride=Z), rows (stride=1) and the full axis
    (stride=1, size=N).
    """
    perm = []
    for k in range(N):
        base = (k // (stride * size)) * (stride * size) + (k % stride)
        pos = (k % (stride * size)) // stride
        dst = base + ((pos + shift) % size) * stride
        perm.append((k, dst))
    return perm


@dataclass(frozen=True)
class TieredAxis:
    """A (hosts x dph) split of the K processors in host-major order
    (processor k = host k // dph, position k % dph).

    The reference lowers every round onto the tier it uses: a dev-axis
    ppermute (intra-host), a host-axis ppermute (inter-host), or a joint
    permute over both axes when a round mixes tiers.  Here the transfer
    goes by rank whatever the tier; the axis only classifies each leg
    (`leg_tier`) for `ProcMesh.legs`.
    """

    hosts: int
    dph: int


def leg_tier(perm, axis: TieredAxis | None) -> str:
    """The tier the reference's `_tiered_ppermute` lowers `perm` onto:
    "dev" (host-local, every host the same local pair set), "host" (fixed
    position, every position the same host pair set) or "joint"; "flat"
    without a tiered axis."""
    if axis is None:
        return "flat"
    dph = axis.dph
    if all(s // dph == d // dph for s, d in perm):
        by_host: dict[int, set] = {}
        for s, d in perm:
            by_host.setdefault(s // dph, set()).add((s % dph, d % dph))
        legs = set(map(frozenset, by_host.values()))
        if len(by_host) == axis.hosts and len(legs) == 1:
            return "dev"
    if all(s % dph == d % dph for s, d in perm):
        by_pos: dict[int, set] = {}
        for s, d in perm:
            by_pos.setdefault(s % dph, set()).add((s // dph, d // dph))
        legs = set(map(frozenset, by_pos.values()))
        if len(by_pos) == dph and len(legs) == 1:
            return "host"
    return "joint"


# ---------------------------------------------------------------------------
# the processor mesh
# ---------------------------------------------------------------------------

def world() -> tuple[int, int]:
    """(G, rank) of the default process group; (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class _Permute:
    """One static partial permutation compiled for this rank: index
    tensors for the pairs inside the block and, per peer rank, the rows it
    sends and the rows it receives (both sides list a peer's pairs sorted
    by (src, dst), so they agree on the order)."""

    def __init__(self, mesh: "ProcMesh", perm):
        lo, hi, P = mesh.lo, mesh.hi, mesh.P
        dev = mesh.device
        src_of = np.full(hi - lo, -1, np.int64)
        local_src, local_dst = [], []
        sends: dict[int, list[int]] = {}
        recvs: dict[int, list[int]] = {}
        self.crosses = False
        for s, d in sorted(perm):
            rs, rd = s // P, d // P
            self.crosses |= rs != rd
            if rd == mesh.rank:
                src_of[d - lo] = s
                if rs == mesh.rank:
                    local_src.append(s - lo)
                    local_dst.append(d - lo)
                else:
                    recvs.setdefault(rs, []).append(d - lo)
            elif rs == mesh.rank:
                sends.setdefault(rd, []).append(s - lo)

        def idx(rows):
            return torch.as_tensor(rows, dtype=torch.long, device=dev)

        self.perm = tuple(perm)
        self.gather = None
        if not recvs and (src_of >= 0).all():
            self.gather = idx(src_of - lo)      # every processor receives
        self.src, self.dst = idx(local_src), idx(local_dst)
        self.peers = [(r, idx(sends[r]) if r in sends else None,
                       idx(recvs[r]) if r in recvs else None)
                      for r in sorted(set(sends) | set(recvs))]
        self.tier = leg_tier(perm, mesh.tiered)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        sent = self._start(lambda rows: x.index_select(0, rows), x.shape[1:],
                           x.dtype, x.device)
        if self.gather is not None:
            out = x.index_select(0, self.gather)
        else:
            out = x.new_zeros(x.shape)
            if self.src.numel():
                out.index_copy_(0, self.dst, x.index_select(0, self.src))
        for recv, got in self._finish(sent):
            out.index_copy_(0, recv, got)
        return out

    def move(self, buf: torch.Tensor, gather: torch.Tensor,
             scatter: torch.Tensor) -> None:
        """In place on buf (K/G, slots, W): buf[d, scatter[d]] <-
        buf[s, gather[s]] for every pair (s, d) of the permutation.  Only
        the pairs' rows are read and written: a processor that receives
        nothing keeps its slots (the reference writes the zeros it receives
        into its trash slot, which is cleared after every leg anyway)."""
        shape = (gather.shape[1],) + buf.shape[2:]

        def take(rows):
            return buf[rows[:, None], gather[rows]]

        sent = self._start(take, shape, buf.dtype, buf.device)
        if self.src.numel():
            buf[self.dst[:, None], scatter[self.dst]] = take(self.src)
        for recv, got in self._finish(sent):
            buf[recv[:, None], scatter[recv]] = got

    def _start(self, take, shape, dtype, device):
        """Post this rank's sends (the rows `take` picks for each peer) and
        receives in one `batch_isend_irecv`."""
        if not self.peers:
            return None
        import torch.distributed as dist

        ops, landed = [], []
        for peer, send, recv in self.peers:
            if send is not None:
                ops.append(dist.P2POp(dist.isend, take(send).contiguous(),
                                      peer))
            if recv is not None:
                got = torch.empty((recv.numel(),) + tuple(shape), dtype=dtype,
                                  device=device)
                ops.append(dist.P2POp(dist.irecv, got, peer))
                landed.append((recv, got))
        return dist.batch_isend_irecv(ops), landed

    @staticmethod
    def _finish(sent):
        """Wait for `_start`'s transfers; the (rows, received) pairs."""
        if sent is None:
            return []
        reqs, landed = sent
        for req in reqs:
            req.wait()
        return landed


class ProcMesh:
    """K processors in contiguous blocks of K/G on the G ranks of the
    default process group (G = 1 without one); this rank owns processors
    [lo, hi) on `device`.

    `ppermute(x, key, perm)` applies a static permutation to the block x
    (leading axis: this rank's processors), compiled into index tensors the
    first time its `key` is seen; later calls only launch work.  `legs`
    counts the executed legs per tier (see `TieredAxis`), `cross_rank`
    those with a pair of processors on two ranks.
    """

    def __init__(self, K: int, device, tiered: TieredAxis | None = None):
        G, rank = world()
        if K % G:
            raise ValueError(f"the mesh splits K={K} processors over G={G} "
                             "ranks in equal blocks: K % G must be 0")
        self.K, self.G, self.rank = K, G, rank
        self.P = K // G
        self.lo, self.hi = rank * self.P, (rank + 1) * self.P
        self.device = torch.device(device)
        self.tiered = tiered
        self.legs: Counter = Counter()
        self.cross_rank = 0
        self._perms: dict = {}
        if G > 1:
            import torch.distributed as dist

            want = "nccl" if self.device.type == "cuda" else "gloo"
            have = dist.get_backend()
            if have != want:
                raise RuntimeError(
                    f"a mesh on {self.device} across {G} ranks needs a "
                    f"{want!r} process group, not {have!r}")
            dist.barrier()  # the communicator's first collective: all ranks

    @property
    def block(self) -> slice:
        return slice(self.lo, self.hi)

    def rows(self, table: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        """This rank's rows of a (K, ...) host table, on the device."""
        return torch.as_tensor(np.ascontiguousarray(table[self.lo:self.hi]),
                               device=self.device).to(dtype)

    def leg(self, key, perm) -> _Permute:
        """The compiled permutation of `key` (`perm` is the pair list or a
        function that builds it, called once per key), counted as one leg
        run."""
        op = self._perms.get(key)
        if op is None:
            op = self._perms[key] = _Permute(
                self, perm() if callable(perm) else perm)
        self.legs[op.tier] += 1
        self.cross_rank += op.crosses
        return op

    def ppermute(self, x: torch.Tensor, key, perm) -> torch.Tensor:
        """`perm` applied to this rank's block x (leading axis: processors);
        a processor that receives nothing gets zeros."""
        return self.leg(key, perm)(x)

    def group_perm(self, x: torch.Tensor, stride: int, size: int,
                   shift: int) -> torch.Tensor:
        """`ppermute` by `_group_perm(K, stride, size, shift)`."""
        return self.ppermute(x, ("group", stride, size, shift),
                             lambda: _group_perm(self.K, stride, size, shift))

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """Every rank's block of y, concatenated in processor order (the
        same tensor on every rank)."""
        if self.G == 1:
            return y
        import torch.distributed as dist

        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(self.G)]
        dist.all_gather(parts, y)
        return torch.cat(parts)

    def describe(self) -> str:
        tiers = ", ".join(f"{k} {v}" for k, v in sorted(self.legs.items()))
        return (f"G={self.G} ranks x {self.P} processors on {self.device}; "
                f"legs run so far by tier: {tiers or 'none'} "
                f"({self.cross_rank} across ranks)")


class MeshStep:
    """A mesh program: `body` maps this rank's (K/G, w) int32 block to its
    output block; a call returns the first `rows_out` rows of the gathered
    (K, w) output (every rank gets the same)."""

    def __init__(self, mesh: ProcMesh, body, rows_out: int):
        self.mesh, self.body, self.rows_out = mesh, body, rows_out

    def __call__(self, xb: torch.Tensor) -> torch.Tensor:
        if xb.shape[0] != self.mesh.P:
            raise ValueError(f"the block of rank {self.mesh.rank} holds "
                             f"{self.mesh.P} processors, got {xb.shape[0]}")
        return self.mesh.gather(self.body(xb))[: self.rows_out]


# ---------------------------------------------------------------------------
# universal prepare-and-shoot (or sub-groups of the processors)
# ---------------------------------------------------------------------------

def _slot_index_map(p: int, T_p: int) -> list[int]:
    """idx(l): slot l (digits LSD-first base p+1) -> paper offset delta."""
    m = (p + 1) ** T_p
    idx = []
    for l in range(m):
        digs = []
        ll = l
        for _ in range(T_p):
            digs.append(ll % (p + 1))
            ll //= p + 1
        # digit b_s (s = 1..T_p) contributes b_s * (p+1)^(T_p - s)
        delta = sum(b * (p + 1) ** (T_p - s - 1) for s, b in enumerate(digs))
        idx.append(delta)
    return idx


@dataclass(frozen=True)
class UniversalTables:
    """Per-processor constants for mesh prepare-and-shoot of one matrix set."""

    K: int          # group size (paper's K)
    p: int
    T_p: int
    T_s: int
    m: int
    n: int          # ceil(K/m)
    n_pad: int      # (p+1)^T_s slot padding
    coef: np.ndarray  # (N, n_pad, m) uint32 — shoot-packet init coefficients
    corr: np.ndarray  # (N, m) uint32 — eq. (4) overlap correction
    group_stride: int
    group_size: int


def build_universal_tables(
    field, mats: list[np.ndarray], N: int, p: int, group_stride: int = 1
) -> UniversalTables:
    """Tables for parallel prepare-and-shoot instances on groups of size K.

    `mats[g]` is the K x K matrix of group g; groups partition the N
    processors with members spaced `group_stride` apart (see _group_perm).
    Requires m <= K (true whenever K >= p+1 ... asserted).
    """
    K = mats[0].shape[0]
    n_groups = N // K
    assert len(mats) == n_groups
    L, T_p, T_s, m = phase_split(K, p)
    assert m <= K, f"tiny-group corner (m={m} > K={K}) unsupported on mesh"
    n = math.ceil(K / m)
    n_pad = (p + 1) ** T_s
    idx = _slot_index_map(p, T_p)
    coef = np.zeros((N, n_pad, m), np.uint32)
    corr = np.zeros((N, m), np.uint32)
    for dev in range(N):
        pos = (dev % (group_stride * K)) // group_stride  # local index k
        # group id: enumerate groups in the same order as mats
        g = (dev // (group_stride * K)) * group_stride + (dev % group_stride)
        C = np.asarray(mats[g], np.int64) % field.q
        k = pos
        for l_t in range(n):
            s = (k + l_t * m) % K
            for l in range(m):
                coef[dev, l_t, l] = C[(k - idx[l]) % K, s]
        # eq. (4): offsets delta in [0, m*n - K) duplicated once
        dup = m * n - K
        for l in range(m):
            if idx[l] < dup:
                corr[dev, l] = C[(k - idx[l]) % K, k]
    return UniversalTables(K, p, T_p, T_s, m, n, n_pad, coef, corr,
                           group_stride, K)


def universal_rows(t: UniversalTables, mesh: ProcMesh) -> torch.Tensor:
    """This rank's (K/G, n_pad + 1, m) int32 rows of [coef; corr]: the A
    operands of the combine's batched `gf_matmul`."""
    return mesh.rows(np.concatenate([t.coef, t.corr[:, None, :]], axis=1))


def mesh_universal_a2a(x: torch.Tensor, cc: torch.Tensor,
                       tables: UniversalTables, mesh: ProcMesh) -> torch.Tensor:
    """Body: x (K/G, W) int32 block -> the encoded block.

    cc (K/G, n_pad + 1, m) is this rank's rows of `universal_rows`: the
    shoot-packet coefficients and, in row n_pad, the eq. (4) duplicate
    term, both applied to the prepared buffer in one batched `gf_matmul`.
    """
    from ..kernels.gf_matmul import gf_matmul_batched

    K, p, T_p, T_s, m = tables.K, tables.p, tables.T_p, tables.T_s, tables.m
    gs, n_pad = tables.group_stride, tables.n_pad
    P, W = x.shape

    # ---- prepare: Bruck-contiguous growth (m = (p+1)^T_p slots) ----------
    buf = torch.zeros((P, m, W), dtype=torch.int32, device=x.device)
    buf[:, 0] = x
    size = 1
    for t in range(1, T_p + 1):
        stride = (p + 1) ** (T_p - t)
        held = buf[:, :size]
        for rho in range(1, p + 1):
            buf[:, rho * size:(rho + 1) * size] = mesh.group_perm(
                held, gs, K, rho * stride)
        size *= p + 1

    # ---- local encode and eq. (4) duplicate term: one batched launch -----
    w_all = gf_matmul_batched(cc, buf)           # (P, n_pad + 1, W)
    dup = w_all[:, n_pad]
    w = w_all[:, :n_pad]

    # ---- shoot: (p+1)-nomial reduce of the w slots ------------------------
    for t in range(1, T_s + 1):
        blk = (p + 1) ** t
        sub = (p + 1) ** (t - 1)
        w_r = w.reshape(P, n_pad // blk, blk, W)  # a view of w_all
        acc = w_r[:, :, 0]
        for rho in range(1, p + 1):
            recv = mesh.group_perm(w_r[:, :, rho * sub], gs, K,
                                   rho * sub * m)
            acc = _add(acc, recv)
        # survivor slots are multiples of blk; the slots consumed this
        # round (rho * sub) are cleared, the rest kept for later rounds
        w_r[:, :, 0] = acc
        for rho in range(1, p + 1):
            w_r[:, :, rho * sub] = 0

    # ---- eq. (4) overlap correction ---------------------------------------
    return _sub(w[:, 0], dup)


# ---------------------------------------------------------------------------
# radix-2 DFT stages (Sec. V-A, P = 2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DFTTables:
    Z: int          # group size = 2^H
    H: int
    ca: np.ndarray  # (H, N) uint32: own coefficient per stage
    cb: np.ndarray  # (H, N) uint32: partner coefficient per stage
    group_stride: int


def build_dft_tables(
    field, N: int, Z: int, group_stride: int = 1, inverse: bool = False
) -> DFTTables:
    """Radix-2 permuted-DFT stage coefficients for groups of size Z."""
    from .dft_a2a import _stage_matrix

    H = int(round(math.log2(Z)))
    assert 2**H == Z and (field.q - 1) % Z == 0
    ca = np.zeros((H, N), np.uint32)
    cb = np.zeros((H, N), np.uint32)
    stages = range(H)
    for h in stages:
        pos = 2 ** (H - h - 1)
        for dev in range(N):
            j = (dev % (group_stride * Z)) // group_stride  # index in group
            member0 = j & ~pos  # group member with bit cleared
            mat = _stage_matrix(field, Z, 2, H, h, member0)
            if inverse:
                mat = gauss_inverse(field, mat)
            d = (j >> int(math.log2(pos))) & 1
            ca[h, dev] = mat[d, d]
            cb[h, dev] = mat[1 - d, d]
    if inverse:
        ca = ca[::-1].copy()
        cb = cb[::-1].copy()
    return DFTTables(Z, H, ca, cb, group_stride)


def _dft_perm(N: int, Z: int, group_stride: int, pos: int):
    perm = []
    for k in range(N):
        j = (k % (group_stride * Z)) // group_stride
        jp = j ^ pos
        perm.append((k, k + (jp - j) * group_stride))
    return perm


def mesh_dft(x: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor,
             tables: DFTTables, mesh: ProcMesh, inverse: bool = False
             ) -> torch.Tensor:
    """Body: (K/G, W) -> (K/G, W). ca/cb are this rank's (K/G, H) rows of
    the tables' transposed coefficients.

    Stage order is baked into the tables (build with inverse=True for the
    inverse transform). Each stage: one pairwise exchange + butterfly.
    """
    Z, H, gs = tables.Z, tables.H, tables.group_stride
    v = x
    for h in range(H):
        pos = 2 ** (H - h - 1) if not inverse else 2 ** h
        recv = mesh.ppermute(v, ("dft", gs, Z, pos),
                             lambda pos=pos: _dft_perm(mesh.K, Z, gs, pos))
        # both products are < 2^32: one int64 sum, one reduction
        v = (ca[:, h, None].long() * v + cb[:, h, None].long() * recv
             ).remainder_(Q).int()
    return v


# ---------------------------------------------------------------------------
# draw-and-loose (Sec. V-B)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DrawLooseTables:
    sp: StructuredPoints
    univ: UniversalTables | None  # draw phase (columns, size M), None if M=1
    dft: DFTTables | None         # loose phase (rows, size Z), None if Z=1
    scale: np.ndarray             # (N,) uint32 alpha_i^j (or inverse)
    inverse: bool


def build_draw_loose_tables(
    field, sp: StructuredPoints, N_devices: int, p: int, inverse: bool = False
) -> DrawLooseTables:
    M, Z = sp.M, sp.Z
    K = M * Z
    n_rep = N_devices // K  # multiple independent grids along the axis
    univ = None
    if M > 1:
        vm = _v_m_matrix(field, sp)
        if inverse:
            vm = gauss_inverse(field, vm)
        univ = build_universal_tables(field, [vm] * (Z * n_rep), N_devices, p,
                                      group_stride=Z)
    dft = None
    if Z > 1:
        dft = build_dft_tables(field, N_devices, Z, group_stride=1,
                               inverse=inverse)
    scale = np.zeros(N_devices, np.uint32)
    for dev in range(N_devices):
        k = dev % K
        i, j = k // Z, k % Z
        s = pow(sp.alpha(i), j, field.q)
        if inverse:
            s = pow(s, field.q - 2, field.q)
        scale[dev] = s
    return DrawLooseTables(sp, univ, dft, scale, inverse)


def _v_m_matrix(field, sp: StructuredPoints) -> np.ndarray:
    alphas_z = np.array([pow(sp.alpha(i), sp.Z, field.q) for i in range(sp.M)],
                        np.int64)
    return vandermonde(field, alphas_z)


def draw_loose_rows(t: DrawLooseTables, mesh: ProcMesh) -> dict:
    """This rank's table rows for `mesh_draw_loose`."""
    rows = {"scale": mesh.rows(t.scale)[:, None]}
    if t.univ is not None:
        rows["cc"] = universal_rows(t.univ, mesh)
    if t.dft is not None:
        rows["ca"] = mesh.rows(t.dft.ca.T)
        rows["cb"] = mesh.rows(t.dft.cb.T)
    return rows


def mesh_draw_loose(x: torch.Tensor, t: DrawLooseTables, rows: dict,
                    mesh: ProcMesh) -> torch.Tensor:
    """Body. `rows` is this rank's `draw_loose_rows`."""
    v = x
    if not t.inverse:
        if t.univ is not None:
            v = mesh_universal_a2a(v, rows["cc"], t.univ, mesh)
        v = _mul(rows["scale"], v)
        if t.dft is not None:
            v = mesh_dft(v, rows["ca"], rows["cb"], t.dft, mesh)
    else:
        if t.dft is not None:
            v = mesh_dft(v, rows["ca"], rows["cb"], t.dft, mesh, inverse=True)
        v = _mul(rows["scale"], v)
        if t.univ is not None:
            v = mesh_universal_a2a(v, rows["cc"], t.univ, mesh)
    return v


# ---------------------------------------------------------------------------
# generic schedule-IR lowering: compile ANY `core.schedule.RoundIR` (in
# particular a `tier_commute`-rewritten one, whose rounds no longer match
# the hand-built table paths above) into per-processor slot tables +
# permutation legs.  The mesh_* bodies above stay the path for canonical
# schedules; this is the general one.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IRLeg:
    """One partial-permutation step of a round: every processor sends and
    receives at most once; messages are `width`-lane packet bundles (short
    bundles pad with trash-slot lanes that receivers scatter back to
    trash)."""

    perm: tuple                 # ((src_dev, dst_dev), ...)
    gather: np.ndarray          # (n_dev, width) int32 slots to read
    scatter: np.ndarray         # (n_dev, width) int32 slots to write


@dataclass(frozen=True)
class IRCombineLayer:
    """One dependency layer of a round's combines (terms only reference
    slots written by earlier rounds/legs/layers), as padded per-processor
    tables: out <- sum_t coeff[., t] * buf[term[., t]]."""

    out_idx: np.ndarray         # (n_dev, n_comb) int32 (pad -> trash)
    coeff: np.ndarray           # (n_dev, n_comb, n_term) uint32 (pad -> 0)
    term: np.ndarray            # (n_dev, n_comb, n_term) int32


@dataclass(frozen=True)
class IRMeshProgram:
    """A `RoundIR` compiled for processors-on-the-mesh execution: per
    processor packet slots (slot 0 is the trash slot all padding routes
    through), and per round a list of permutation legs plus combine
    layers."""

    n_dev: int
    n_slots: int
    init_slot: np.ndarray       # (n_dev,) int32 slot of the local input row
    out_slot: np.ndarray        # (n_dev,) int32 slot of the local output row
    rounds: tuple               # ((legs, layers), ...) per IR round

    def device_arrays(self) -> dict[str, np.ndarray]:
        """All (n_dev, ...) tables, keyed as the reference keys them."""
        arrs = {"init": self.init_slot[:, None], "out": self.out_slot[:, None]}
        for r, (legs, layers) in enumerate(self.rounds):
            for i, leg in enumerate(legs):
                arrs[f"g{r}_{i}"] = leg.gather
                arrs[f"s{r}_{i}"] = leg.scatter
            for i, lay in enumerate(layers):
                arrs[f"o{r}_{i}"] = lay.out_idx
                arrs[f"c{r}_{i}"] = lay.coeff
                arrs[f"t{r}_{i}"] = lay.term
        return arrs


def build_ir_mesh_program(ir, dev_of: list[int]) -> IRMeshProgram:
    """Compile `ir` (a `core.schedule.RoundIR`) against the processor ->
    mesh-processor overlay `dev_of` (encode: source k -> k, sink K+r -> r,
    the Sec. III-A grid).  Sends between processors that share a mesh
    processor are free (one buffer); other sends decompose into
    partial-permutation legs with at most one send and one receive per
    mesh processor; combines split into intra-round dependency layers."""
    n_dev = max(dev_of) + 1
    TRASH = 0
    next_slot = [1] * n_dev                       # slot 0 = trash
    slot_of: dict[tuple[int, int], int] = {}      # (dev, packet) -> slot

    def alloc(dev: int, pid: int) -> int:
        key = (dev, pid)
        if key not in slot_of:
            slot_of[key] = next_slot[dev]
            next_slot[dev] += 1
        return slot_of[key]

    init_slot = np.zeros(n_dev, np.int32)
    for proc, pid in ir.inputs:
        init_slot[dev_of[proc]] = alloc(dev_of[proc], pid)

    rounds = []
    for rnd in ir.rounds:
        # ---- sends -> partial-permutation legs --------------------------
        cross = [s for s in rnd.sends
                 if dev_of[s.src] != dev_of[s.dst]]
        leg_sends: list[list] = []
        for s in cross:
            placed = False
            for leg in leg_sends:
                if all(dev_of[s.src] != dev_of[o.src]
                       and dev_of[s.dst] != dev_of[o.dst] for o in leg):
                    leg.append(s)
                    placed = True
                    break
            if not placed:
                leg_sends.append([s])
        legs = []
        for sends in leg_sends:
            width = max(len(s.packets) for s in sends)
            gather = np.full((n_dev, width), TRASH, np.int32)
            scatter = np.full((n_dev, width), TRASH, np.int32)
            perm = []
            for s in sends:
                sd, dd = dev_of[s.src], dev_of[s.dst]
                perm.append((sd, dd))
                for i, pid in enumerate(s.packets):
                    gather[sd, i] = slot_of[(sd, pid)]
                    scatter[dd, i] = alloc(dd, pid)
            legs.append(IRLeg(tuple(sorted(perm)), gather, scatter))
        for s in rnd.sends:                       # same-device: already held
            if dev_of[s.src] == dev_of[s.dst]:
                for pid in s.packets:
                    slot_of[(dev_of[s.dst], pid)] = slot_of[
                        (dev_of[s.src], pid)]

        # ---- combines -> dependency layers ------------------------------
        layer_of: dict[int, int] = {}             # out pid -> layer index
        grouped: list[list] = []
        for c in rnd.combines:
            lvl = 0
            for _, pid in c.terms:
                if pid in layer_of:
                    lvl = max(lvl, layer_of[pid] + 1)
            layer_of[c.out] = lvl
            while len(grouped) <= lvl:
                grouped.append([])
            grouped[lvl].append(c)
        layers = []
        for combs in grouped:
            per_dev: dict[int, list] = {}
            for c in combs:
                per_dev.setdefault(dev_of[c.proc], []).append(c)
            n_comb = max(len(v) for v in per_dev.values())
            n_term = max((len(c.terms) for c in combs), default=0) or 1
            out_idx = np.full((n_dev, n_comb), TRASH, np.int32)
            coeff = np.zeros((n_dev, n_comb, n_term), np.uint32)
            term = np.full((n_dev, n_comb, n_term), TRASH, np.int32)
            for dev, cs in per_dev.items():
                for i, c in enumerate(cs):
                    out_idx[dev, i] = alloc(dev, c.out)
                    for t, (cref, pid) in enumerate(c.terms):
                        coeff[dev, i, t] = ir.coeffs[cref] % ir.q
                        term[dev, i, t] = slot_of[(dev, pid)]
            layers.append(IRCombineLayer(out_idx, coeff, term))
        rounds.append((tuple(legs), tuple(layers)))

    out_slot = np.zeros(n_dev, np.int32)
    for proc, pid in ir.outputs:
        out_slot[dev_of[proc]] = slot_of[(dev_of[proc], pid)]
    return IRMeshProgram(n_dev, max(next_slot), init_slot, out_slot,
                         tuple(rounds))


def ir_rows(prog: IRMeshProgram, mesh: ProcMesh) -> dict:
    """This rank's rows of `prog.device_arrays()`: slot indices as int64
    (index tensors), coefficients as int32."""
    return {k: mesh.rows(v, torch.int32 if k[0] == "c" else torch.long)
            for k, v in prog.device_arrays().items()}


def mesh_ir_encode(x: torch.Tensor, rows: dict, prog: IRMeshProgram,
                   mesh: ProcMesh) -> torch.Tensor:
    """Body: (K/G, W) int32 block -> (K/G, W) running the compiled IR
    program.  `rows` is this rank's `ir_rows`."""
    P, W = x.shape
    ar = torch.arange(P, device=x.device)
    col = ar[:, None]
    buf = torch.zeros((P, prog.n_slots, W), dtype=torch.int32,
                      device=x.device)
    buf[ar, rows["init"][:, 0]] = x
    for r, (legs, layers) in enumerate(prog.rounds):
        for i, leg in enumerate(legs):
            # only the leg's senders and receivers touch their slots: a
            # leg of one wide bundle moves one processor's rows, not K/G
            mesh.leg(("ir", id(prog), r, i), leg.perm).move(
                buf, rows[f"g{r}_{i}"], rows[f"s{r}_{i}"])
            buf[:, 0] = 0                                 # re-arm trash
        for i, _lay in enumerate(layers):
            coeff = rows[f"c{r}_{i}"]                     # (P, n_comb, n_term)
            term = rows[f"t{r}_{i}"]
            # each product < 2^32: the int64 sum of the terms is exact
            acc = torch.zeros((P, coeff.shape[1], W), dtype=torch.int64,
                              device=x.device)
            for t in range(coeff.shape[2]):
                acc += coeff[:, :, t, None].long() * buf[col, term[:, :, t]]
            buf[col, rows[f"o{r}_{i}"]] = acc.remainder_(Q).int()
            buf[:, 0] = 0
    return buf[ar, rows["out"][:, 0]]
