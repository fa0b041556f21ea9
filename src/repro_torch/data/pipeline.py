"""Deterministic synthetic LM data pipeline; the port of
`repro/data/pipeline.py`.

Produces a reproducible token stream (per-step, per-shard seeded: any host
can regenerate any shard independently, so the pipeline is restart- and
elastic-safe with no dataloader state to checkpoint beyond the step
counter).  Batches mimic a Zipf-ish unigram mixture with induced bigram
structure, so a small model shows a real learning curve.

`host_batch` is the JAX package's numpy code as it is: the same (step,
shard, n_shards) gives the same int32 arrays, bit for bit.
`device_batch` holds those values as int64 tensors (torch's index type).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.config import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def host_batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """numpy batch for this host's shard of the global batch."""
        per = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        # structured stream: markov-ish chain over a Zipf unigram base
        base = rng.zipf(1.3, size=(per, self.seq_len + 1)) % self.vocab
        shift = rng.integers(0, 17, size=(per, 1))
        mix = rng.random((per, self.seq_len + 1)) < 0.7
        chain = (np.roll(base, 1, axis=1) * 31 + shift) % self.vocab
        toks = np.where(mix, chain, base).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def device_batch(self, step: int, device=None) -> dict:
        """`host_batch(step)` as int64 tensors on `device` (None means
        CUDA, raising without a card)."""
        from ..api.registry import resolve_device

        dev = resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                for k, v in self.host_batch(step).items()}


def make_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """Tensors on the meta device (shapes and dtypes, no memory) for every
    model input of this (arch, shape) cell: the JAX package's
    `ShapeDtypeStruct`s, with int32 token ids as int64."""
    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    B = shape.global_batch
    if shape.kind == "decode":
        return {"token": spec((B,), torch.int64)}
    S = shape.seq_len
    S_text = S
    specs = {}
    if cfg.family == "vlm":
        S_text = max(S - cfg.n_patches, 1)
        specs["vision_embeds"] = spec((B, cfg.n_patches, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = spec((B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    specs["tokens"] = spec((B, S_text), torch.int64)
    if shape.is_train:
        specs["labels"] = spec((B, S_text), torch.int64)
    return specs
