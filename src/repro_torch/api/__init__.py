"""Unified coding API of the port: one session handle over the encode and
decode stacks, one planner layer, one backend registry.

    from repro_torch.api import CodeSpec, CodedSystem

    system = CodedSystem(CodeSpec(kind="rs", K=16, R=4), backend="local")
    cw = system.codeword(x)      # [x | parity] systematic codeword
    system.fail([2, 17]); x2 = system.read(cw); system.heal()

Architecture (each layer public, each composing the one below):

    CodedSystem (api.system)   — session: erasure state, auto-replanned
                                 degraded reads, rebuild, streamed/
                                 batched/queued submission, stats
    Encoder / Decoder planners — plan-then-execute: host tables + schedule
    (api.planner,                selection resolved once, cached by spec
     recover.planner)            (x erasure pattern for decode) and device
    Backend registry           — `Backend` protocol + `register_backend`;
    (api.registry,               capability checks at plan time; built-ins
     api.backends)               "local" (the card), "simulator" (the
                                 host-only round network) and "mesh" (the
                                 paper's rounds on processors, K/G per
                                 rank)
    kernels / core             — the CUDA field-matmul and NTT kernels and
                                 their plain versions; numpy host tables,
                                 the schedule IR, the round simulator and
                                 the processor mesh

Plans execute on any backend with bitwise-identical results;
`plan.run_stream`/`run_batched` stream them (api.stream).  Every entry
point runs on "cuda" unless given `device=` (moot on the simulator).
"""
from ..topo import (
    Placement,
    TieredCost,
    TieredLinkModel,
    Topology,
    place,
    tiered_encode_cost,
)
from .planner import ALPHA_DEFAULT, BETA_BITS_DEFAULT, EncodePlan, Encoder, method_costs
from .registry import (
    Backend,
    BackendCapabilityError,
    RunStats,
    available_backends,
    get_backend,
    register_backend,
    resolve_device,
    unregister_backend,
)
from .spec import CodeSpec
from .stream import StreamStats, default_chunk_w
from .system import CodedSystem, LinkModel

__all__ = [
    "CodeSpec", "CodedSystem", "LinkModel",
    "Encoder", "EncodePlan", "method_costs",
    "Backend", "BackendCapabilityError", "RunStats",
    "register_backend", "unregister_backend", "get_backend",
    "available_backends", "resolve_device",
    "StreamStats", "default_chunk_w",
    "Topology", "TieredLinkModel", "TieredCost",
    "Placement", "place", "tiered_encode_cost",
    "cache_clear", "cache_info",
    "ALPHA_DEFAULT", "BETA_BITS_DEFAULT",
]


def cache_clear() -> None:
    """Clear Encoder plans, Decoder plans, and the shared host-table cache
    together (decode tables hold references into the host tables)."""
    Encoder.cache_clear()


def cache_info() -> dict:
    """Combined cache statistics of both stacks:
    {"encode": Encoder.cache_info(), "decode": Decoder.cache_info()}."""
    from ..recover.planner import Decoder

    return {"encode": Encoder.cache_info(), "decode": Decoder.cache_info()}
