"""LR schedules: cosine and WSD (warmup-stable-decay, minicpm
arXiv:2404.06395); the port of `repro/optim/schedules.py`.

`lr(step)` takes a Python int or an integer tensor (on any device) and
returns a 0-d float32 tensor on the step's device, computed in float32 as
`jnp` computes it (Python scalars enter as float32 operands).
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(peak_lr: float, warmup: int, stable: int, decay: int,
                 floor: float = 0.01):
    """Warmup -> flat -> linear decay to floor*peak."""
    def lr(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = peak_lr * (1 - (1 - floor) * t)
        out = torch.where(step < warmup, warm, torch.full_like(step, peak_lr))
        return torch.where(step > warmup + stable, dec, out)

    return lr


def make_schedule(kind: str, peak_lr: float, total: int, warmup: int | None = None):
    warmup = warmup if warmup is not None else max(10, total // 100)
    if kind == "wsd":
        stable = int(0.8 * (total - warmup))
        return wsd_schedule(peak_lr, warmup, stable, total - warmup - stable)
    return cosine_schedule(peak_lr, warmup, total)
