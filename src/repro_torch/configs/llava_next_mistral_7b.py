"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
The vision tower is a STUB: input_specs() provides precomputed anyres patch
embeddings (B, 2880, d_model) prepended to the text sequence.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    rope_theta=1e6,
    n_patches=2880,  # anyres 2x2 grid + base: 5 * 576
)
