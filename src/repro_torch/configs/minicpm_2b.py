"""minicpm-2b [dense]: 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753 — WSD schedule, depth-scaled residuals (mup-style)
[arXiv:2404.06395; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    rope_theta=1e4,
    tie_embeddings=True,
    scale_depth=1.4,
    scale_emb=12.0,
    logit_scale=9.0,  # d_model / 256
)
