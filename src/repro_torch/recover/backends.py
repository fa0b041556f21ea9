"""The decode half of the local backend (the `Backend` object binding it to
the registry lives in `api.backends`).

    local — single-device `kernels.ops.decode_blocks` (the `gf_matmul` CUDA
            kernel) on the plan's torch device

It returns the JAX package's repaired symbols bitwise: row j holds
v^T D[:, j] over F_q for erased position `plan.erased[j]`.  The simulator
and mesh halves are not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.backends import run_on_device


def local_decode_callable(plan):
    """The plan's local-decode function (K, w) int32 -> (|E|, w) int32 on
    `plan.device`, with the repair matrix D kept on the device; built once
    and cached for the plan's lifetime."""
    if plan._local_fn is None:
        from ..kernels.ops import decode_blocks

        D = torch.as_tensor((plan.tables.D % plan.field.q).astype(np.int32),
                            device=plan.device)

        def fn(v):
            return decode_blocks(v, D)
        plan._local_fn = fn
    return plan._local_fn


def run_local(plan, v: np.ndarray) -> np.ndarray:
    """Single-device decode on the kernel path (no network)."""
    return run_on_device(local_decode_callable(plan), v, plan.field.q,
                         plan.device, "local_decode", kind=plan.spec.kind,
                         K=plan.spec.K, E=len(plan.erased))
