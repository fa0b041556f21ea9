"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit).  A card set below
that limit runs slower under load; every run prints its power limit."""
from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "int8_ops_per_s": 1.979e15,
    "bf16_flops_per_s": 989e12,
    "fp32_flops_per_s": 67e12,
    "memory_bytes": 80e9,
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks(kind: str | None) -> dict:
    """The peak table of a card by `torch.cuda.get_device_name()`; the H100
    SXM's for a name the table lacks, so a number is never read against no
    peak."""
    return PEAKS.get(kind or "", H100_SXM)


def bandwidth(kind: str | None = None) -> float:
    return peaks(kind)["hbm_bytes_per_s"]
