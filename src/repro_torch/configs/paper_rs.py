"""The paper's own workload: systematic Reed-Solomon decentralized encoding
of storage shards across the data axis (Secs. III + VI). Used by the
coded-checkpoint feature and the paper-table benchmarks; parameters here set
the default (N devices -> R parity) code."""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperRSConfig:
    name: str = "paper-rs"
    R_fraction: float = 0.25     # parity overhead (R = N/4)
    p_ports: int = 1
    method: str = "rs"           # 'rs' (Thm. 7) or 'universal' (Sec. IV)
    shard_bytes: int = 1 << 20   # per-device state shard size to encode


CONFIG = PaperRSConfig()
