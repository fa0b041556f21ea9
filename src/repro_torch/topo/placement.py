"""Processor -> (host, device)-slot placements and per-tier closed forms.

A `Placement` assigns each framework processor (sources 0..K-1, sinks
K..N-1) a slot of a `Topology`; the host of processor i is then
`slots[i] // devices_per_host`.  Policies:

  * "flat"     — topology-oblivious round-robin across hosts (the strawman
                 a scheduler that ignores the hierarchy produces): adjacent
                 processors land on different hosts, so group-local
                 prepare-and-shoot traffic crosses hosts.
  * "affinity" — pack each phase-one A2A group onto a single host whenever
                 the group size fits `devices_per_host` (first-fit), then
                 spread the remaining processors emptiest-host-first so
                 the sinks get a host of their own when one is free.

`tiered_encode_cost` gives the exact per-tier (C1, C2) split of the
Table-I model under a placement, when the placement is *uniform* per
phase (every list co-hosted, or every list spread across distinct hosts).
The split leans on the round structure of the schedules:

  * Phase-level split: the framework cost is a2a + broadcast
    (`cost_model.framework`), and the broadcast/reduce tree part
    (T, T*W) is exact round-for-round, so the phase boundary is exact
    whenever the flat total is (which the drift ledger already asserts).
  * A2A phases run all groups lockstep with identical schedules, and
    every member sends in every active round — so if ANY group is not
    co-hosted, EVERY round of the phase carries a cross-host message and
    the whole phase is inter; if all groups are co-hosted it is intra.
  * Broadcast/reduce trees are not all-send-every-round, so their rows
    must be uniformly co-hosted (intra) or pairwise cross-host (inter);
    anything mixed has no closed form and returns None (the simulator's
    measured per-tier counters still apply).
  * DFT: stage h moves data at stride P^(H-h-1); each stage is its own
    lockstep A2A phase, so the all-or-nothing rule applies per stage and
    the form is exact for ANY placement.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.cauchy import cost_cauchy
from ..core.collectives import cost_broadcast
from ..core.cost_model import LinearCost
from ..core.dft_a2a import _stage_groups
from ..core.prepare_shoot import cost_universal
from .model import TieredCost, Topology


@dataclass(frozen=True)
class Placement:
    """An injective map of processors onto topology slots."""

    topology: Topology
    slots: tuple[int, ...]
    policy: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "slots", tuple(self.slots))
        n = self.topology.n_slots
        if len(set(self.slots)) != len(self.slots):
            raise ValueError("placement slots must be distinct")
        for s in self.slots:
            if not 0 <= s < n:
                raise ValueError(f"slot {s} outside topology [0, {n})")

    @property
    def n_procs(self) -> int:
        return len(self.slots)

    def host_of(self, proc: int) -> int:
        return self.slots[proc] // self.topology.devices_per_host

    def tier(self, src: int, dst: int) -> str:
        return "intra" if self.host_of(src) == self.host_of(dst) else "inter"


# ---------------------------------------------------------------------------
# group structure of the framework schedules (mirrors core/framework.py)
# ---------------------------------------------------------------------------

def _grid(spec) -> tuple[int, list[list[int]], list[list[int]]]:
    """(M, a2a_groups, broadcast_rows) for a framework spec, deduplicated
    exactly as `decentralized_encode` builds them (borrowed processors
    appear once)."""
    K, R = spec.K, spec.R
    if K >= R:
        M = math.ceil(K / R)

        def pos_proc(r: int, m: int) -> int:
            k = r + m * R
            return k if k < K else K + r

        groups = [[pos_proc(r, m) for r in range(R)] for m in range(M)]
        rows = []
        for r in range(R):
            row = [pos_proc(r, m) for m in range(M)]
            sink = K + r
            rows.append([sink] + [q for q in row if q != sink])
        return M, groups, rows

    M = math.ceil(R / K)

    def pos_proc(k: int, m: int) -> int:
        r = k + m * K
        return K + r if r < R else k

    groups = [[pos_proc(k, m) for k in range(K)] for m in range(M)]
    rows = [[k] + [pos_proc(k, m) for m in range(M) if pos_proc(k, m) != k]
            for k in range(K)]
    return M, groups, rows


def encode_groups(spec) -> list[list[int]]:
    """The A2A groups of the framework schedule (phase 1 for K >= R,
    phase 2 for K < R) — the heavy-traffic lists the affinity policy packs
    one-per-host.  Empty for dft (identity placement already keeps every
    stage with stride < devices_per_host host-local)."""
    if spec.kind == "dft":
        return []
    return _grid(spec)[1]


# ---------------------------------------------------------------------------
# placement policies
# ---------------------------------------------------------------------------

def n_procs(spec) -> int:
    """Processors a placement must cover: N = K + R for the framework
    schedules; the dft transform runs in-place on the K sources only."""
    return spec.K if spec.kind == "dft" else spec.K + spec.R


def place(spec, topology: Topology, policy: str = "affinity") -> Placement:
    """Place the spec's processors (see `n_procs`) on the topology."""
    N = n_procs(spec)
    if topology.n_slots < N:
        raise ValueError(
            f"topology has {topology.n_slots} slots < N={N} processors")
    hosts, dph = topology.hosts, topology.devices_per_host
    if policy == "flat":
        # round-robin over hosts, filling device position i // hosts
        slots = tuple((i % hosts) * dph + (i // hosts) for i in range(N))
        return Placement(topology, slots, "flat")
    if policy != "affinity":
        raise ValueError(f"unknown placement policy {policy!r} "
                         "(have 'flat', 'affinity')")
    if spec.kind == "dft":
        # identity keeps every stage with stride < devices_per_host intra
        return Placement(topology, tuple(range(N)), "affinity")
    free = [list(range(h * dph, (h + 1) * dph)) for h in range(hosts)]
    slot_of: dict[int, int] = {}
    for group in encode_groups(spec):
        members = [m for m in dict.fromkeys(group) if m not in slot_of]
        host = next((h for h in range(hosts)
                     if len(free[h]) >= len(members)), None)
        if host is None:
            continue  # group larger than any remaining host: leftover pass
        for m in members:
            slot_of[m] = free[host].pop(0)
    for m in (i for i in range(N) if i not in slot_of):
        # emptiest host first, so the sinks claim a free host when one exists
        host = max(range(hosts), key=lambda h: (len(free[h]), -h))
        slot_of[m] = free[host].pop(0)
    return Placement(topology, tuple(slot_of[i] for i in range(N)), "affinity")


# ---------------------------------------------------------------------------
# per-tier closed form
# ---------------------------------------------------------------------------

def _phase_tier(lists, placement: Placement, all_send: bool) -> str | None:
    """Tier of a lockstep phase over member `lists`.

    all_send=True (A2A phases): every member sends in every active round,
    so one non-co-hosted list makes the whole phase inter — always
    determined.  all_send=False (broadcast/reduce trees): only uniform
    all-intra or all-pairwise-inter placements are attributable; mixed
    returns None.  Returns "any" when no list carries traffic.
    """
    tiers = set()
    for members in lists:
        hs = [placement.host_of(m) for m in dict.fromkeys(members)]
        if len(hs) <= 1:
            continue  # singleton: no messages
        distinct = len(set(hs))
        tiers.add("intra" if distinct == 1
                  else "inter" if distinct == len(hs) else "mixed")
    if not tiers:
        return "any"
    if tiers == {"intra"}:
        return "intra"
    if all_send or tiers == {"inter"}:
        return "inter"
    return None


def tiered_encode_cost(spec, method: str, placement: Placement,
                       sgrs=None) -> TieredCost | None:
    """Exact per-tier split of the Table-I encode cost under a placement.

    Returns None when the placement is not uniform per phase (see module
    docstring); the per-tier sums always equal the flat model's totals
    whenever a split is returned.  C2 is scaled by spec.W, matching
    `method_costs` / the measured `RoundNetwork` counters.
    """
    if placement.n_procs < n_procs(spec):
        raise ValueError(
            f"placement covers {placement.n_procs} processors, "
            f"need {n_procs(spec)}")
    W = spec.W
    parts = {"intra": LinearCost(0, 0), "inter": LinearCost(0, 0)}

    def add(tier: str | None, part: LinearCost) -> bool:
        if tier is None:
            return False
        parts["intra" if tier == "any" else tier] += part
        return True

    if spec.kind == "dft":
        K, P = spec.K, spec.P
        H = 0
        while P ** H < K:
            H += 1
        c1, c2 = cost_universal(P, spec.p)
        stage = LinearCost(c1, c2 * W)
        for h in range(H):
            groups = _stage_groups(K, P, H, h)
            add(_phase_tier(groups, placement, all_send=True), stage)
        return TieredCost(parts["intra"], parts["inter"])

    M, groups, rows = _grid(spec)
    if method == "rs":
        if sgrs is None:
            from ..core.cauchy import StructuredGRS

            sgrs = StructuredGRS.build(spec.field, spec.K, spec.R, P=spec.P,
                                       lagrange=spec.kind == "lagrange")
        c1, c2 = cost_cauchy(sgrs, 0, spec.p)
    else:
        c1, c2 = cost_universal(min(spec.K, spec.R), spec.p)
    a2a_part = LinearCost(c1, c2 * W)
    t_br, c2_br = cost_broadcast(M + 1, spec.p, W)
    br_part = LinearCost(t_br, c2_br)

    ok = add(_phase_tier(groups, placement, all_send=True), a2a_part)
    ok = ok and add(_phase_tier(rows, placement, all_send=False), br_part)
    if not ok:
        return None
    return TieredCost(parts["intra"], parts["inter"])
