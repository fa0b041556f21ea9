"""Hierarchical topology subsystem: tiered links, placement, per-tier costs.

Production fleets are not the paper's uniform p-port clique — they are
hierarchical: fast intra-host links (NVLink/ICI-class) and slow inter-host
links (DCN-class).  This package models that as a two-tier refinement of
the paper's linear cost model, *without touching the schedules*:

    Topology(hosts, devices_per_host) — the machine shape
    TieredLinkModel                   — alpha/beta per tier (Table I, twice)
    Placement / place(spec, topo, policy) — processors -> (host, device)
        slots; "affinity" packs each prepare-and-shoot group onto one host,
        "flat" is the topology-oblivious round-robin strawman
    tiered_encode_cost(...)           — per-tier (C1, C2) closed form,
        asserted bit-for-bit against the simulator's per-tier accounting

The schedules themselves are placement-independent (Remark 1: scheduling
is data-independent, and a placement only relabels which physical link a
message crosses), so outputs are bitwise identical under ANY placement —
only the tier attribution of each round changes.  The `RoundNetwork`
measures that attribution exactly; the drift ledger checks it against
`tiered_encode_cost` whenever the closed form applies.
"""
from .model import TieredCost, TieredLinkModel, Topology
from .placement import (Placement, encode_groups, n_procs, place,
                        tiered_encode_cost)

__all__ = [
    "Topology", "TieredLinkModel", "TieredCost",
    "Placement", "place", "encode_groups", "n_procs", "tiered_encode_cost",
]
