"""The decode halves of the two built-in backends (the `Backend` objects
binding these to the registry live in `api.backends`).

    simulator — all-to-all decode among the K kept survivors on the
                round network, with the erased processors fail()-ed
                (exact numpy oracle on the host; measured C1/C2 recorded
                thread-locally on `plan.last_stats` / `plan.sim_net`)
    local     — single-device `kernels.ops.decode_blocks` (the `gf_matmul`
                CUDA kernel) on the plan's torch device

Both return the JAX package's repaired symbols bitwise: row j holds
v^T D[:, j] over F_q for erased position `plan.erased[j]`.  The mesh half
is not ported yet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from ..api.backends import run_on_device
from ..core import schedule
from ..core.simulator import RoundNetwork


def run_simulator(plan, v: np.ndarray) -> tuple[np.ndarray, RoundNetwork]:
    """Decode on the paper's p-port round network: the erased processors
    are failed (any schedule touching them would raise); returns the
    repaired symbols and the network with its measured C1/C2.  Executes
    the plan's decode `RoundIR` (`plan.schedule_ir()`) generically."""
    spec, f = plan.spec, plan.field
    net = RoundNetwork(spec.N, spec.p)
    net.fail(plan.erased)
    y = schedule.execute(plan.schedule_ir(), f, f.arr(v), net)
    return np.asarray(y, np.int64), net


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
