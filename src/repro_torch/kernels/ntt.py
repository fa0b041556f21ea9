"""`ntt`: batched radix-2 NTT over F_65537, the CUDA kernel of `csrc/ntt.cu`.

Computes, for each of C independent columns of x (Z, C), the Z-point NTT in
decimation-in-frequency order: output position k holds X[rev(k)], which is
the paper's permuted DFT D_Z Pi (Sec. V-A).  It replaces the JAX package's
Pallas TPU kernel (`repro/kernels/ntt.py`, `_ntt_kernel` / `_ntt_stages`);
the source says how.  The source holds two kernels, picked by Z: for
Z <= 64 (`REGS_MAX_Z`) each thread keeps one column in registers; above it a
block keeps a column slab in shared memory.  A CUDA tensor launches one of
them on the current stream (no synchronise) or raises; a CPU tensor runs the
plain version `ref.ntt_plain`.  `ntt.launches` counts kernel launches, and
`ntt.launches_by_kernel` splits them into "registers" and "slab".
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

MAX_Z = 4096  # one (Z, bw) slab per block in shared memory; a four-step
              # split would lift this (the TPU kernel has the same limit)
REGS_MAX_Z = 64  # a whole column in one thread's registers

_TWIDDLES: dict[tuple, torch.Tensor] = {}
_HOST_TWIDDLES: dict[tuple, np.ndarray] = {}


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


def slab_width(Z: int) -> int:
    """Columns per block of the slab kernel: a (Z, bw) int32 slab of 64 KiB
    (Z = 128: bw = 128; 128 KiB at Z = 4096, since bw stops at 8)."""
    return max(8, min(128, 16384 // Z))


def _device_twiddles(Z: int, inverse: bool, device) -> torch.Tensor:
    key = (Z, inverse, device)
    tw = _TWIDDLES.get(key)
    if tw is None:
        tw = _TWIDDLES[key] = torch.as_tensor(
            ntt_twiddles(Z, inverse).astype(np.int32), device=device)
    return tw


def _host_twiddles(Z: int, inverse: bool) -> np.ndarray:
    key = (Z, inverse)
    tw = _HOST_TWIDDLES.get(key)
    if tw is None:
        tw = _HOST_TWIDDLES[key] = np.ascontiguousarray(ntt_twiddles(Z, inverse))
    return tw


@functools.lru_cache(maxsize=None)
def _slab_launcher():
    # ntt_launch(x, out, tw, H, C, lbw, scale, inverse, stream)
    return build.entry("ntt", "ntt_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_uint,
                                                ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _regs_launcher():
    # ntt_regs_launch(x, out, tw_host, H, C, scale, inverse, stream)
    return build.entry("ntt", "ntt_regs_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_uint, ctypes.c_int,
                                                ctypes.c_void_p])


def ntt(x: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Batched NTT along axis 0: x (Z, C) int32 in [0, q) -> (Z, C) int32,
    Z a power of two <= 4096.

    Forward: out[k] = sum_j x[j] * beta^(j * rev(k))   (== x @ D_Z Pi).
    Inverse: exact inverse of forward (includes the 1/Z scaling).
    """
    if x.dim() != 2:
        raise ValueError(f"ntt takes a (Z, C) array, got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"ntt takes int32, got {x.dtype}")
    Z, C = x.shape
    H = Z.bit_length() - 1
    if Z < 1 or 1 << H != Z:
        raise ValueError(f"ntt needs Z a power of two, got Z={Z}")
    if Z > MAX_Z:
        raise ValueError(f"ntt's kernel takes Z <= {MAX_Z}, got Z={Z}")
    if x.device.type == "cpu":
        return ntt_plain(x, inverse=inverse).to(torch.int32)
    if x.device.type != "cuda":
        raise ValueError(f"ntt runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("ntt's kernel takes a contiguous row-major array")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scale = pow(Z, FERMAT_Q - 2, FERMAT_Q) if inverse else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if Z <= REGS_MAX_Z:
            kernel = "registers"
            tw = _host_twiddles(Z, inverse)
            err = _regs_launcher()(x.data_ptr(), out.data_ptr(), tw.ctypes.data,
                                   H, C, scale, int(inverse), stream)
        else:
            kernel = "slab"
            tw = _device_twiddles(Z, inverse, x.device)
            lbw = slab_width(Z).bit_length() - 1
            err = _slab_launcher()(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                                   H, C, lbw, scale, int(inverse), stream)
        build.check(err, f"ntt ({kernel})")
    ntt.launches += 1
    ntt.launches_by_kernel[kernel] += 1
    return out


ntt.launches = 0
ntt.launches_by_kernel = {"registers": 0, "slab": 0}
