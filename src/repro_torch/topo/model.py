"""Machine shape and two-tier link-cost model.

`Topology` is the physical shape — `hosts` machines with
`devices_per_host` devices each, slot `s` living on host
`s // devices_per_host` (host-major order, matching the hierarchical
mesh backend's device grid).

`TieredLinkModel` prices the paper's (C1, C2) pair once per tier: a
round crossing hosts pays the inter-tier alpha/beta, a host-local round
pays the intra pair.  `TieredCost` carries the per-tier split; its
`total` collapses back to the flat `LinearCost` sum so single-tier
`LinkModel.us` keeps working on it unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.cost_model import LinearCost

# Table-I-style defaults, mirrored from api.planner (duplicated here on
# purpose: topo must not import api, or the import cycle closes).
ALPHA_DEFAULT = 1e-5
BETA_BITS_DEFAULT = 17e-9


@dataclass(frozen=True)
class Topology:
    """A two-level machine: `hosts` x `devices_per_host` slots."""

    hosts: int
    devices_per_host: int

    def __post_init__(self):
        if self.hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"Topology needs hosts >= 1 and devices_per_host >= 1, "
                f"got ({self.hosts}, {self.devices_per_host})")

    @property
    def n_slots(self) -> int:
        return self.hosts * self.devices_per_host

    def host_of(self, slot: int) -> int:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        return slot // self.devices_per_host


@dataclass(frozen=True)
class TieredCost:
    """Per-tier (C1, C2): `intra` host-local rounds, `inter` crossing ones."""

    intra: LinearCost
    inter: LinearCost

    @property
    def flat(self) -> LinearCost:
        return self.intra + self.inter

    def total(self, alpha: float, beta_bits: float, width_elems: int = 1):
        """Collapse to the single-tier cost — lets plain LinkModel price it."""
        return self.flat.total(alpha, beta_bits, width_elems)


@dataclass(frozen=True)
class TieredLinkModel:
    """Per-tier latency/inverse-bandwidth, Table-I style twice over."""

    alpha_intra: float = ALPHA_DEFAULT
    beta_bits_intra: float = BETA_BITS_DEFAULT
    alpha_inter: float = ALPHA_DEFAULT
    beta_bits_inter: float = BETA_BITS_DEFAULT

    def __post_init__(self):
        for name in ("alpha_intra", "beta_bits_intra",
                     "alpha_inter", "beta_bits_inter"):
            if getattr(self, name) < 0:
                raise ValueError(
                    f"TieredLinkModel.{name} must be >= 0, "
                    f"got {getattr(self, name)!r}")

    @classmethod
    def from_ratio(cls, ratio: float, *, alpha: float = ALPHA_DEFAULT,
                   beta_bits: float = BETA_BITS_DEFAULT) -> "TieredLinkModel":
        """Inter tier `ratio` times more expensive than the intra base."""
        if ratio < 1:
            raise ValueError(f"inter/intra ratio must be >= 1, got {ratio!r}")
        return cls(alpha_intra=alpha, beta_bits_intra=beta_bits,
                   alpha_inter=alpha * ratio, beta_bits_inter=beta_bits * ratio)

    def us(self, cost) -> float:
        """Model time in microseconds for a TieredCost, LinearCost or RunStats.

        Flat inputs carry no tier split, so they are priced conservatively
        at the inter tier (every round may cross hosts).
        """
        if isinstance(cost, TieredCost):
            return (cost.intra.total(self.alpha_intra, self.beta_bits_intra)
                    + cost.inter.total(self.alpha_inter, self.beta_bits_inter)
                    ) * 1e6
        # RunStats and LinearCost both expose .total(alpha, beta_bits)
        return cost.total(self.alpha_inter, self.beta_bits_inter) * 1e6
