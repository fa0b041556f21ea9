"""`gf_matmul`: (a @ b) mod 65537, the CUDA kernel of `csrc/gf_matmul.cu`.

It replaces the JAX package's Pallas TPU kernel (`repro/kernels/gf_matmul.py`,
`_gf_matmul_kernel`); the source says how.  The kernel multiplies 8-bit limbs
on the int8 tensor cores; `a_limbs` builds a's limb planes on the device, the
only plain torch work the wrapper adds.  A CUDA tensor launches the kernel on
the current stream (no synchronise) or raises; a CPU tensor runs the plain
version `ref.gf_matmul_plain`.  `gf_matmul.launches` counts kernel launches.

`gf_matmul_batched` runs B independent products in one launch (the mesh
backend's per-processor combine) in one of two designs, chosen from (M, K)
by `_batched_design`: "small", the CUDA-core kernel of
`csrc/gf_matmul_small.cu` (persistent blocks, pipelined staging of b) for
small M and K, and "imma", the tensor-core kernel's batched entry, for
the rest.  Its plain version is `ref.gf_matmul_batched_plain`; its count
`gf_matmul_batched.launches` counts both designs, and
`gf_matmul_batched.launches_by_design` each.
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
# the CUDA-core design's limits: u64 sums of K <= 32 products stay exact,
# a[z] fits its shared memory
_SMALL_MAX_M = 64
_SMALL_MAX_K = 32
# It is chosen while its M K multiply-adds a column stay below the time of
# the column's 4 (M + K) bytes: at 16.75 T INT32 multiply-adds/s against
# 3.35 TB/s, M K <= 20 (M + K) at the full rate, 10 (M + K) at half.  The
# card's sweep (chip_smoke.py) keeps 10: the small design is the faster up
# to (17 x 16) (ratio 8.2) and ties the tensor cores at (33 x 32) (16.2).
_SMALL_CROSSOVER = 10
_DESIGNS = ("small", "imma")


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


@functools.lru_cache(maxsize=None)
def _small_launcher():
    # gf_matmul_small_launch(a, b, c, B, M, N, K, stream)
    return build.entry("gf_matmul_small", "gf_matmul_small_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])


def _batched_design(M: int, K: int) -> str:
    """The design `gf_matmul_batched` runs for (M x K) . (K x N) products:
    "small" (CUDA cores, bound by bytes) while M <= 64, K <= 32 and
    M K <= _SMALL_CROSSOVER (M + K), else "imma" (tensor cores)."""
    if (M <= _SMALL_MAX_M and K <= _SMALL_MAX_K
            and M * K <= _SMALL_CROSSOVER * (M + K)):
        return "small"
    return "imma"


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


def gf_matmul_batched(a: torch.Tensor, b: torch.Tensor, *,
                      _design: str | None = None) -> torch.Tensor:
    """(a[z] @ b[z]) mod 65537 for every z: a (B, M, K), b (B, K, N) int32
    with values in [0, q) on one device -> (B, M, N) int32, in one launch."""
    # _design forces one design for the kernel checks (tests, chip_smoke.py)
    if _design is not None and _design not in _DESIGNS:
        raise ValueError(f"gf_matmul_batched: unknown design {_design!r}, "
                         f"expected one of {_DESIGNS}")
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
    design = _design or _batched_design(M, K)
    if design == "small" and (M > _SMALL_MAX_M or K > _SMALL_MAX_K):
        raise ValueError(f"gf_matmul_batched's small design takes M <= "
                         f"{_SMALL_MAX_M} and K <= {_SMALL_MAX_K}, got M={M}, "
                         f"K={K}")
    out = torch.empty((B, M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if design == "small":
            err = _small_launcher()(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), B, M, N, K, stream)
        else:
            al = a_limbs(a)
            ahi = al[:, 2].amax(dim=2)  # (B, M): rows holding a 65536
            err = _batched_launcher()(
                al.data_ptr(), ahi.data_ptr(), b.data_ptr(), out.data_ptr(),
                B, M, N, K, al.shape[-1], stream)
        build.check(err, f"gf_matmul_batched ({design})")
    gf_matmul_batched.launches += 1
    gf_matmul_batched.launches_by_design[design] += 1
    return out


gf_matmul_batched.launches = 0
gf_matmul_batched.launches_by_design = dict.fromkeys(_DESIGNS, 0)
