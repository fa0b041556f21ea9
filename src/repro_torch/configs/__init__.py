"""Assigned architecture registry: one module per arch, `CONFIG` in each
(copies of the JAX package's `repro/configs/`, imported from this package)."""
from __future__ import annotations

from importlib import import_module

from ..models.config import SHAPES, ArchConfig, ShapeConfig

ARCH_IDS = [
    "llava_next_mistral_7b",
    "qwen3_14b",
    "qwen3_1_7b",
    "minicpm_2b",
    "qwen1_5_32b",
    "whisper_large_v3",
    "kimi_k2_1t_a32b",
    "phi3_5_moe_42b_a6_6b",
    "hymba_1_5b",
    "mamba2_780m",
    "paper_rs",  # the paper's own "architecture": RS-coded storage encode
]


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch}; available: {ARCH_IDS}")
    return import_module(f"{__name__}.{arch}").CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS if a != "paper_rs"}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_applicable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; reason if skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (skip: full-attention arch)"
    return True, ""
