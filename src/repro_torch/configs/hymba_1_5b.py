"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + mamba heads per layer,
sliding-window attention (3 global layers approximated by a uniform window
across the layer stack, as in the JAX package). [arXiv:2411.13676; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    rope_theta=1e4,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=64,
    sliding_window=1024,
)
