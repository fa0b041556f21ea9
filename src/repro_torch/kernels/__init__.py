"""The two hand-written CUDA kernels of the port and their plain versions.

    gf_matmul  — (a @ b) mod 65537            (csrc/gf_matmul.cu)
                 and its batched entry `gf_matmul_batched`
    ntt        — batched radix-2 NTT, axis 0   (csrc/ntt.cu)

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version (`ref`) for a CPU tensor; `build` compiles the sources on first use.
`gf_solve` (exact Gauss-Jordan inverse in plain torch on the device, then
`gf_matmul`) is the decode solve.
"""
from . import ops
from .gf_matmul import gf_matmul, gf_matmul_batched
from .gf_solve import gf_gauss_inverse, gf_solve
from .ntt import ntt, ntt_twiddles
from .ntt_encode import NTTEncodeParams, ntt_encode
from .ref import gf_matmul_batched_plain, gf_matmul_plain, ntt_plain

__all__ = ["gf_matmul", "gf_matmul_plain", "gf_matmul_batched",
           "gf_matmul_batched_plain", "gf_gauss_inverse", "gf_solve",
           "ntt", "ntt_plain", "ntt_twiddles", "NTTEncodeParams", "ntt_encode",
           "ops"]
