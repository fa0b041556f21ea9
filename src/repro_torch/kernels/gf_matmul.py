"""`gf_matmul`: (a @ b) mod 65537, the CUDA kernel of `csrc/gf_matmul.cu`.

It replaces the JAX package's Pallas TPU kernel (`repro/kernels/gf_matmul.py`,
`_gf_matmul_kernel`); the source says how.  A CUDA tensor launches the kernel
on the current stream (no synchronise) or raises; a CPU tensor runs the plain
version `ref.gf_matmul_plain`.  `gf_matmul.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .ref import gf_matmul_plain

_MAX_M = 32 * 65535          # the kernel's grid rows: 32 rows each
_INT_MAX = (1 << 31) - 1


@functools.lru_cache(maxsize=None)
def _launcher():
    # gf_matmul_launch(a, b, c, M, N, K, stream)
    return build.entry("gf_matmul", "gf_matmul_launch",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])


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
    if M > _MAX_M or max(K, N) > _INT_MAX:
        raise ValueError(f"gf_matmul kernel takes M <= {_MAX_M} and K, N < 2^31, "
                         f"got M={M}, K={K}, N={N}")
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(_launcher()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                M, N, K, stream), "gf_matmul")
    gf_matmul.launches += 1
    return out


gf_matmul.launches = 0
