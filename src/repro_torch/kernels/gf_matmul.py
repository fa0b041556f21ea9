"""`gf_matmul`: (a @ b) mod 65537, the CUDA kernel of `csrc/gf_matmul.cu`.

It replaces the JAX package's Pallas TPU kernel (`repro/kernels/gf_matmul.py`,
`_gf_matmul_kernel`); the source says how.  The kernel multiplies 8-bit limbs
on the int8 tensor cores; `a_limbs` builds a's limb planes on the device, the
only plain torch work the wrapper adds.  A CUDA tensor launches the kernel on
the current stream (no synchronise) or raises; a CPU tensor runs the plain
version `ref.gf_matmul_plain`.  `gf_matmul.launches` counts kernel launches.

`gf_matmul_batched` is the same kernel's batched entry: B independent
products in one launch (the mesh backend's per-processor combine); its
plain version is `ref.gf_matmul_batched_plain`, its count
`gf_matmul_batched.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import gf_matmul_batched_plain, gf_matmul_plain

_INT_MAX = (1 << 31) - 1
_MAX_K = 1 << 30  # keeps the kernel's int k indices clear of overflow
_K_ALIGN = 16  # a's limb planes are staged in 16-byte loads
_MAX_BATCH = 65535  # the batch index is the grid's y


@functools.lru_cache(maxsize=None)
def _launcher():
    # gf_matmul_launch(al, ahi, b, c, M, N, K, Kp, stream)
    return build.entry("gf_matmul", "gf_matmul_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _batched_launcher():
    # gf_matmul_batched_launch(al, ahi, b, c, B, M, N, K, Kp, stream)
    return build.entry("gf_matmul", "gf_matmul_batched_launch",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])


def a_limbs(a: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) int32 in [0, q) -> its (..., 3, M, Kp) uint8 limb
    planes, K-major: a = a0 + 2^8 a1 + 2^16 a2 with a0, a1 in [0, 255] and
    a2 in {0, 1} (a2 = 1 only for 65536 == -1).  The limbs are the low
    three bytes of each little-endian int32, so one strided copy builds the
    planes.  Kp is K rounded up to 16 (at least 16); the pad is 0."""
    *lead, M, K = a.shape
    Kp = max(1, -(-K // _K_ALIGN)) * _K_ALIGN
    make = torch.empty if Kp == K else torch.zeros
    planes = make((*lead, 3, M, Kp), dtype=torch.uint8, device=a.device)
    if a.numel():  # (an empty a has no byte view)
        limbs = a.contiguous().view(torch.uint8).view(*lead, M, K, 4)
        planes[..., :K] = limbs.movedim(-1, -3)[..., :3, :, :]
    return planes


def gf_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a @ b) mod 65537: a (M, K), b (K, N) int32 with values in [0, q) on
    one device -> (M, N) int32."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gf_matmul needs (M, K) x (K, N), got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"gf_matmul takes int32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return gf_matmul_plain(a, b).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"gf_matmul runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gf_matmul's kernel takes contiguous row-major operands")
    M, K = a.shape
    N = b.shape[1]
    if max(M, N) > _INT_MAX or K > _MAX_K:
        raise ValueError(f"gf_matmul kernel takes M, N < 2^31 and K <= 2^30, "
                         f"got M={M}, K={K}, N={N}")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        al = a_limbs(a)
        ahi = al[2].amax(dim=1)  # rows holding a 65536: a2 takes part there
        stream = torch.cuda.current_stream().cuda_stream
        build.check(_launcher()(al.data_ptr(), ahi.data_ptr(), b.data_ptr(),
                                out.data_ptr(), M, N, K, al.shape[2], stream),
                    "gf_matmul")
    gf_matmul.launches += 1
    return out


gf_matmul.launches = 0


def gf_matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a[z] @ b[z]) mod 65537 for every z: a (B, M, K), b (B, K, N) int32
    with values in [0, q) on one device -> (B, M, N) int32, in one launch."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"gf_matmul_batched needs (B, M, K) x (B, K, N), "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"gf_matmul_batched takes int32, got {a.dtype}, "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return gf_matmul_batched_plain(a, b).to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"gf_matmul_batched runs on cuda or cpu, not "
                         f"{a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gf_matmul_batched's kernel takes contiguous operands")
    B, M, K = a.shape
    N = b.shape[2]
    if B > _MAX_BATCH:
        raise ValueError(f"gf_matmul_batched takes B <= {_MAX_BATCH} (the "
                         f"grid's y), got B={B}")
    if max(M, N) > _INT_MAX or K > _MAX_K:
        raise ValueError(f"gf_matmul_batched kernel takes M, N < 2^31 and "
                         f"K <= 2^30, got M={M}, K={K}, N={N}")
    out = torch.empty((B, M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        al = a_limbs(a)
        ahi = al[:, 2].amax(dim=2)  # (B, M): rows holding a 65536
        stream = torch.cuda.current_stream().cuda_stream
        build.check(_batched_launcher()(
            al.data_ptr(), ahi.data_ptr(), b.data_ptr(), out.data_ptr(),
            B, M, N, K, al.shape[-1], stream), "gf_matmul_batched")
    gf_matmul_batched.launches += 1
    return out


gf_matmul_batched.launches = 0
