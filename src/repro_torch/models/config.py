"""Architecture configuration — one dataclass covers all 10 assigned archs
(a copy of the JAX package's `repro/models/config.py`)."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0            # 0 => d_model // n_heads
    qk_norm: bool = False        # qwen3-style per-head RMSNorm on q, k
    qkv_bias: bool = False       # qwen1.5-style
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 64
    ssm_conv: int = 4

    # hybrid / attention variants
    sliding_window: int = 0      # 0 = full attention
    global_attn_every: int = 0   # hymba: every k-th layer is global

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500         # encoder sequence (stub frontend output)

    # VLM (llava)
    n_patches: int = 0           # vision tokens (stub frontend output)

    # minicpm tricks
    scale_depth: float = 0.0     # residual scale: scale_depth / sqrt(n_layers)
    scale_emb: float = 1.0
    logit_scale: float = 1.0     # minicpm divides logits by d_model/256

    # large-scale training choices
    optimizer: str = "adamw"     # kimi-k2 -> adafactor (device-memory envelope)
    remat: bool = True
    dtype: str = "bfloat16"

    # serving: int8 KV cache (per-token-per-head absmax scales) — halves the
    # decode memory bound
    quantize_kv: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (O(S) decode state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have a decode step

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=2,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            # generous capacity: no token dropping in smoke tests, so the
            # stepwise-decode vs full-forward consistency check is exact
            capacity_factor=8.0,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=16,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            n_frames=32,
            n_patches=min(self.n_patches, 8),
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
