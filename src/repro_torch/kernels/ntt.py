"""`ntt`: batched radix-2 NTT over F_65537, the CUDA kernels of `csrc/ntt.cu`.

Computes, for each of C independent columns of x (Z, C), the Z-point NTT in
decimation-in-frequency order: output position k holds X[rev(k)], which is
the paper's permuted DFT D_Z Pi (Sec. V-A).  It replaces the JAX package's
Pallas TPU kernel (`repro/kernels/ntt.py`, `_ntt_kernel` / `_ntt_stages`);
the source says how.  Z is any power of two that divides q - 1 (1 <= Z <=
2^16, `MAX_Z`), the domain of `ntt_twiddles`.  The least time any of the
kernels could take is set by memory bytes, 8 Z C over the card's 3.35 TB/s
(one read and one write of each element).  The wrapper picks by Z: for Z <=
64 (`REGS_MAX_Z`) each thread keeps one column in registers ("registers");
up to 4096 (`SLAB_MAX_Z`) two register passes meet in one exchange through
shared memory ("slab"); above it one pass on a thread-block cluster of Z / R
blocks, each holding R rows (2048, or 4096 at Z = 2^16) of 8 columns in
shared memory and exchanging the leading stages through the cluster's
distributed shared memory ("cluster").  A CUDA tensor launches the kernels
on the current stream (no synchronise) or raises; a CPU tensor runs the
plain version `ref.ntt_plain`.  `ntt.launches` counts kernel launches, and
`ntt.launches_by_kernel` splits them into "registers", "slab" and
"cluster".
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.field import FERMAT, FERMAT_Q
from . import build
from .ref import ntt_plain

MAX_Z = 1 << 16    # the largest power of two dividing q - 1 = 2^16
REGS_MAX_Z = 64    # a whole column in one thread's registers
SLAB_MAX_Z = 4096  # Z1 * Z2 with both register passes <= 64 values
# rows a block of the cluster kernel holds (8 columns each), as the kernel's
# `with_layout` sets them: 2048 (two blocks an SM) up to 2^15; 4096 at 2^16,
# where 2048 would need 32 blocks a cluster and a cluster holds at most 16
CLUSTER_ROWS = {1 << 13: 2048, 1 << 14: 2048, 1 << 15: 2048, 1 << 16: 4096}


def ntt_twiddles(K: int, inverse: bool = False) -> np.ndarray:
    """(H, K/2) twiddle table for DIF stage h: w_h[j] = root^(j * 2^h)."""
    H = int(math.log2(K))
    assert 2**H == K and (FERMAT_Q - 1) % K == 0
    root = FERMAT.root_of_unity(K)
    if inverse:
        root = pow(root, FERMAT_Q - 2, FERMAT_Q)
    tw = np.zeros((H, K // 2), np.uint32)
    for h in range(H):
        stride = 2**h
        for j in range(K // 2):
            tw[h, j] = pow(root, (j % (K // (2 * stride))) * stride, FERMAT_Q)
    return tw


def _powers(r: int, n: int) -> np.ndarray:
    """[r^0, r^1, ..., r^(n-1)] mod q as int64."""
    out = np.empty(n, np.int64)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * r % FERMAT_Q
    return out


def _bitrev(n: int) -> np.ndarray:
    """rev(a) over log2 n bits for a in [0, n)."""
    bits = n.bit_length() - 1
    a = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((a >> b) & 1) << (bits - 1 - b)
    return rev


def _twist(r: int, z1: int, z2: int, scale: int) -> np.ndarray:
    """(z1, z2) table scale * r^(j rev(a)) at [a, j]: the multiply between a
    pure z1-point DIF of each sequence x[j + a z2] and the z2-point DIFs of
    the contiguous blocks (r of order z1 * z2)."""
    pw = _powers(r, z1 * z2)
    e = (_bitrev(z1)[:, None] * np.arange(z2)[None, :]) % (z1 * z2)
    return _frozen(pw[e] * scale % FERMAT_Q)


def _frozen(a) -> np.ndarray:
    """A read-only uint32 copy: the cached tables are shared by every call."""
    a = np.ascontiguousarray(a, np.uint32)
    a.flags.writeable = False
    return a


def slab_split(Z: int) -> tuple[int, int]:
    """(Z1, Z2) of the slab kernel: Z1 = 2^floor(H/2), Z2 = Z / Z1."""
    z1 = 1 << ((Z.bit_length() - 1) // 2)
    return z1, Z // z1


@functools.lru_cache(maxsize=None)
def slab_tables(Z: int, root: int, scale: int) -> tuple[np.ndarray, np.ndarray]:
    """Host tables of one slab launch for a Z-point transform with `root` (of
    order Z; the inverse root for the inverse): the pass twiddles
    (w1[32] = root^(Z2 e), e < Z1/2; w2[32] = root^(Z1 e), e < Z2/2) and the
    (Z1, Z2) twist table times `scale` (the inverse's Z^-1, else 1), with
    (Z1, Z2) = `slab_split(Z)`."""
    z1, z2 = slab_split(Z)
    tw = np.zeros(64, np.int64)
    tw[:z1 // 2] = _powers(pow(root, z2, FERMAT_Q), z1 // 2)
    tw[32:32 + z2 // 2] = _powers(pow(root, z1, FERMAT_Q), z2 // 2)
    return _frozen(tw), _twist(root, z1, z2, scale)


@functools.lru_cache(maxsize=None)
def cluster_tables(Z: int, root: int, scale: int) -> tuple:
    """Host tables of one cluster launch for Z = Z0 * rows (rows =
    `CLUSTER_ROWS[Z]`): 72 pass twiddles (w0[8] = root^(rows e), e < Z0/2,
    then the rows-point slab's w1[32], w2[32] with root^Z0; its split is
    (rows / 64, 64)), the (Z0, rows) leading-stages twist table times
    `scale` and the slab's (rows / 64, 64) twist table (scale 1)."""
    rows = CLUSTER_ROWS[Z]
    z0 = Z // rows
    sw, stwist = slab_tables(rows, pow(root, z0, FERMAT_Q), 1)
    tw = np.zeros(72, np.int64)
    tw[:z0 // 2] = _powers(pow(root, rows, FERMAT_Q), z0 // 2)
    tw[8:] = sw
    return _frozen(tw), _twist(root, z0, rows, scale), stwist


def roots(Z: int, inverse: bool) -> tuple[int, int]:
    """(root, scale) of a Z-point transform: the root of unity of order Z
    (its inverse for the inverse transform) and the inverse's Z^-1 (else 1)."""
    root = FERMAT.root_of_unity(Z)
    if not inverse:
        return root, 1
    return pow(root, FERMAT_Q - 2, FERMAT_Q), pow(Z, FERMAT_Q - 2, FERMAT_Q)


_DEVICE_TWIST: dict[tuple, tuple] = {}
_TABLES = {"slab": slab_tables, "cluster": cluster_tables}


def _device_twist(kind: str, Z: int, root: int, scale: int, device) -> tuple:
    """(host pass twiddles, device twist table(s)...) of one launch, cached."""
    tw, *twists = _TABLES[kind](Z, root, scale)
    key = (kind, Z, root, scale, device)
    dev = _DEVICE_TWIST.get(key)
    if dev is None:
        dev = _DEVICE_TWIST[key] = tuple(
            torch.as_tensor(t.astype(np.int32), device=device) for t in twists)
    return (tw, *dev)


@functools.lru_cache(maxsize=None)
def regs_tables(Z: int, root: int) -> np.ndarray:
    """The register kernel's twiddles: root^e for e < Z/2 (one word at Z = 1)."""
    return _frozen(_powers(root, max(1, Z // 2)))


@functools.lru_cache(maxsize=None)
def _slab_launcher():
    # ntt_slab_launch(x, out, twist, tw_host, H, C, batches, inverse, stream)
    return build.entry("ntt", "ntt_slab_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int,
                                                ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _cluster_launcher():
    # ntt_cluster_launch(x, out, otwist, stwist, tw_host, H, C, inverse, stream)
    return build.entry("ntt", "ntt_cluster_launch",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p])


def cluster_config(Z: int) -> dict:
    """Launch facts of the cluster kernel at Z (needs the card): blocks a
    cluster, shared bytes a block, columns a cluster, threads a block and,
    per direction, the clusters that can be resident at once
    (`cudaOccupancyMaxActiveClusters`), registers and local bytes a
    thread."""
    fn = build.entry("ntt", "ntt_cluster_config",
                     [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    info = (ctypes.c_int * 10)()
    build.check(fn(Z.bit_length() - 1, info), "ntt_cluster_config")
    facts = dict(zip(("cluster_blocks", "smem_bytes", "columns", "threads"), info))
    for i, d in ((4, "forward"), (7, "inverse")):
        facts[d] = dict(zip(("max_active_clusters", "registers", "local_bytes"),
                            info[i:i + 3]))
    return facts


@functools.lru_cache(maxsize=None)
def _regs_launcher():
    # ntt_regs_launch(x, out, tw_host, H, C, scale, inverse, stream)
    return build.entry("ntt", "ntt_regs_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_uint, ctypes.c_int,
                                                ctypes.c_void_p])


def _launch(kernel: str, err: int) -> None:
    build.check(err, f"ntt ({kernel})")
    ntt.launches += 1
    ntt.launches_by_kernel[kernel] += 1


def _slab(x, out, Z: int, root: int, scale: int, inverse: bool, stream) -> None:
    """One slab launch: the Z-point transform of one (Z, C) block."""
    tw, twist = _device_twist("slab", Z, root, scale, x.device)
    _launch("slab", _slab_launcher()(
        x.data_ptr(), out.data_ptr(), twist.data_ptr(), tw.ctypes.data,
        Z.bit_length() - 1, x.shape[1], 1, int(inverse), stream))


def _cluster(x, out, Z: int, root: int, scale: int, inverse: bool, stream) -> None:
    """One cluster launch: the whole Z-point transform, Z > 4096."""
    tw, otwist, stwist = _device_twist("cluster", Z, root, scale, x.device)
    _launch("cluster", _cluster_launcher()(
        x.data_ptr(), out.data_ptr(), otwist.data_ptr(), stwist.data_ptr(),
        tw.ctypes.data, Z.bit_length() - 1, x.shape[1], int(inverse), stream))


def _run(x, out, inverse: bool, stream) -> None:
    """Launch the kernels of one (Z, C) transform x -> out on `stream`."""
    Z, C = x.shape
    root, scale = roots(Z, inverse)
    if Z <= REGS_MAX_Z:
        tw = regs_tables(Z, root)
        _launch("registers", _regs_launcher()(
            x.data_ptr(), out.data_ptr(), tw.ctypes.data, Z.bit_length() - 1, C,
            scale, int(inverse), stream))
    elif Z <= SLAB_MAX_Z:
        _slab(x, out, Z, root, scale, inverse, stream)
    else:
        _cluster(x, out, Z, root, scale, inverse, stream)


def ntt(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched NTT along axis 0: x (Z, C) int32 in [0, q) -> (Z, C) int32,
    Z a power of two dividing q - 1 (Z <= 2^16).

    Forward: out[k] = sum_j x[j] * beta^(j * rev(k))   (== x @ D_Z Pi).
    Inverse: exact inverse of forward (includes the 1/Z scaling).
    """
    if x.dim() != 2:
        raise ValueError(f"ntt takes a (Z, C) array, got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"ntt takes int32, got {x.dtype}")
    Z, C = x.shape
    H = Z.bit_length() - 1
    if Z < 1 or 1 << H != Z or Z > MAX_Z:
        raise ValueError(f"ntt needs Z a power of two dividing q - 1 = "
                         f"{FERMAT_Q - 1}, got Z={Z}")
    if x.device.type == "cpu":
        return ntt_plain(x, inverse=inverse).to(torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"ntt runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("ntt's kernel takes a contiguous row-major array")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _run(x, out, inverse, torch.cuda.current_stream().cuda_stream)
    return out


ntt.launches = 0
ntt.launches_by_kernel = {"registers": 0, "slab": 0, "cluster": 0}
