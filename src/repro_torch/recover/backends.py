"""The decode halves of the three built-in backends (the `Backend` objects
binding these to the registry live in `api.backends`).

    simulator — all-to-all decode among the K kept survivors on the
                round network, with the erased processors fail()-ed
                (exact numpy oracle on the host; measured C1/C2 recorded
                thread-locally on `plan.last_stats` / `plan.sim_net`)
    mesh      — survivors as processors of the mesh: processor i holds the
                symbol of survivor `plan.kept[i]`; each batch of repair
                columns runs the same universal mesh all-to-all as the
                encode path, its repaired symbols landing on processors
                0..E'-1
    local     — single-device `kernels.ops.decode_blocks` (the `gf_matmul`
                CUDA kernel) on the plan's torch device

All three return the JAX package's repaired symbols bitwise: row j holds
v^T D[:, j] over F_q for erased position `plan.erased[j]`.
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


def run_local(plan, v: np.ndarray, pick=None, into=None) -> np.ndarray:
    """Single-device decode on the kernel path (no network).  `pick` and
    `into` read the survivors from codeword rows and place the repaired
    rows in the answer, on the device (`run_on_device`)."""
    return run_on_device(local_decode_callable(plan), v, plan.field.q,
                         plan.device, "local_decode", pick=pick, into=into,
                         kind=plan.spec.kind, K=plan.spec.K,
                         E=len(plan.erased))


def _mesh_callables(plan) -> list:
    """One mesh program per repair batch on one shared flat `ProcMesh`,
    kept for the plan's lifetime (same caching contract as
    `EncodePlan.mesh_callable`).  Each maps this rank's (K/G, w) block of
    the survivors to the batch's E' repaired rows."""
    if plan._mesh_fns is None:
        from ..core.parity import mesh_parity_encode
        from ..core.shardmap_exec import MeshStep, ProcMesh

        mesh = ProcMesh(plan.spec.K, plan.device)

        def step(b: int, eb: int) -> MeshStep:
            t = plan.tables.mesh_tables(b)
            rows = t.device_rows(mesh)
            return MeshStep(
                mesh, lambda vb: mesh_parity_encode(vb, rows, t, mesh), eb)

        plan._mesh_fns = [step(b, eb) for b, (eb, _)
                          in enumerate(plan.tables.batches())]
    return plan._mesh_fns


def mesh_decode_fn(plan):
    """(K/G, w) int32 survivor block -> (|E|, w) int32: the batches'
    repaired rows, concatenated."""
    fns = _mesh_callables(plan)

    def fn(vb):
        return torch.cat([f(vb) for f in fns])
    return fn


def run_mesh(plan, v: np.ndarray) -> np.ndarray:
    """Decode on the processor mesh: this rank's block of the survivors
    goes to its device; the repaired rows come back from every rank."""
    block = _mesh_callables(plan)[0].mesh.block
    return run_on_device(mesh_decode_fn(plan), np.asarray(v)[block],
                         plan.field.q, plan.device, "mesh_decode",
                         kind=plan.spec.kind, K=plan.spec.K,
                         E=len(plan.erased))
