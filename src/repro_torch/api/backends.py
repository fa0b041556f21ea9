"""The local executor behind `EncodePlan.run`, registered on the
`api.registry` Backend protocol.

    local — single-device encode on the plan's torch device: the NTT fast
            path (`kernels.ntt_encode`, the `ntt` CUDA kernel) or the dense
            `kernels.ops.encode_blocks` field matmul (the `gf_matmul` CUDA
            kernel); no communication schedule at all

It returns the JAX package's sink values bitwise: sink r holds x^T A[:, r]
over F_q.  Inputs/outputs are numpy int64 (K, W) -> (R, W); on the device
payloads are int32.  The decode half lives in `recover.backends`; the
`Backend` object below binds both.  The simulator and mesh backends are
not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.field import FERMAT_Q
from ..obs.trace import kernel_span
from .registry import Backend, register_backend


def run_on_device(fn, x: np.ndarray, q: int, device, name: str,
                  **span_args) -> np.ndarray:
    """numpy payload -> int32 residues on `device` -> `fn` -> numpy int64.

    Each leg is its own `kernel_span`, so a trace splits an operation into
    host work ("host_in": residues as int32; "host_out": back to int64),
    the copies ("h2d", "d2h") and the kernels (`name`)."""
    x = np.asarray(x)
    with kernel_span("host_in"):
        xh = torch.from_numpy(np.ascontiguousarray(x % q, dtype=np.int32))
    with kernel_span("h2d", bytes=xh.numel() * 4):
        xd = xh.to(device)
    with kernel_span(name, w=int(x.shape[1]), **span_args):
        y = fn(xd)
    with kernel_span("d2h", bytes=y.numel() * 4):
        yh = y.cpu()
    with kernel_span("host_out"):
        return yh.numpy().astype(np.int64)


def local_encode_callable(plan):
    """The plan's local-encode function (K, w) int32 -> (R, w) int32 on
    `plan.device`, built once and cached on the plan.

    The planner auto-selects the O(K log K) NTT fast path
    (`kernels.ntt_encode`) for dft and structured rs/lagrange specs when
    their point sets are radix-2 single cosets (in particular, K a power
    of two); otherwise this is the dense `encode_blocks` field matmul with
    the generator block kept on the device.  Both are exact mod-q
    arithmetic, so the choice is bitwise-invisible.
    """
    if plan._local_fn is None:
        params = plan.tables.ntt_params()
        if params is not None:
            from ..kernels.ntt_encode import ntt_encode

            def fn(x):
                return ntt_encode(x, params)
        else:
            from ..kernels.ops import encode_blocks

            A = torch.as_tensor((plan.A % plan.field.q).astype(np.int32),
                                device=plan.device)

            def fn(x):
                return encode_blocks(x, A)
        plan._local_fn = fn
    return plan._local_fn


def run_local(plan, x: np.ndarray) -> np.ndarray:
    """Single-device encode on the kernel path (no network): the cached
    NTT fast path or dense field matmul, per the planner."""
    return run_on_device(local_encode_callable(plan), x, plan.field.q,
                         plan.device, f"local_encode.{plan.local_impl}",
                         kind=plan.spec.kind, K=plan.spec.K)


@register_backend("local")
class LocalBackend(Backend):
    """Single-device kernel path (NTT fast path / dense field matmul) on the
    plan's torch device.  No communication schedule; Fermat arithmetic
    only."""

    field_note = f"the CUDA kernels are Fermat-only, q={FERMAT_Q}"

    def supports_field(self, q: int) -> bool:
        return q == FERMAT_Q

    def encode(self, plan, x):
        return run_local(plan, x)

    def decode(self, plan, v):
        from ..recover.backends import run_local as run_dec

        return run_dec(plan, v)
