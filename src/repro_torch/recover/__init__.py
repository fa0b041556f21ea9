"""Decentralized decode & repair: the recovery dual of `repro_torch.api`.

    from repro_torch.api import CodeSpec
    from repro_torch.recover import Decoder

    spec = CodeSpec(kind="rs", K=16, R=4)
    plan = Decoder.plan(spec, erased=(2, 17), backend="local")
    lost = plan.run(v)       # v: symbols at plan.kept -> symbols at plan.erased
    x    = plan.data(v)      # full original data (degraded read)

Erasure decode of the systematic codeword [x | x^T A] is an encode with the
repair matrix D = S^-1 G[:, E] (S the survivor submatrix of G = [I | A]),
so the local backend runs it on the same `gf_matmul` kernel as the dense
encode, and the simulator runs it as an all-to-all encode among the
survivors with the erased processors `fail()`-ed (`repair_with_faults`
restarts it when more die mid-schedule).  Host tables — submatrix inverse, repair matrix — are cached per
(spec, erasure pattern); see `planner` for the cache contract and `engine`
for the round-network schedule's exact closed-form cost.
"""
from .engine import decentralized_decode, decode_batches, decode_cost
from .planner import (
    DecodePlan,
    Decoder,
    RepairAttempt,
    RepairReport,
    UndecodableError,
    repair_with_faults,
)

__all__ = [
    "Decoder", "DecodePlan", "UndecodableError",
    "RepairAttempt", "RepairReport", "repair_with_faults",
    "decentralized_decode", "decode_batches", "decode_cost",
]
