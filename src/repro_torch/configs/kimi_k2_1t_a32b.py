"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert,
MoE 384 experts top-8, vocab=163840 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

Large-scale choice: Adam's fp32 states (8 B/param = 8 TB) outgrow the
deployment's device memory, so kimi trains with Adafactor (factored second
moment) and fully-sharded bf16 params.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    rope_theta=5e4,
    n_experts=384,
    top_k=8,
    capacity_factor=1.0,
    n_shared_experts=1,
    optimizer="adafactor",
)
