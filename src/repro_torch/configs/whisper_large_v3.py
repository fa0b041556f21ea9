"""whisper-large-v3 [audio]: enc-dec, 32 encoder + 32 decoder layers,
d_model=1280 20H (MHA) d_ff=5120 vocab=51866 — conv/mel frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, 1500, d_model).
[arXiv:2212.04356; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    act="gelu",
    n_frames=1500,
)
