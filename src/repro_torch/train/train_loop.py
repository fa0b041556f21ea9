"""Train step factory: microbatched gradient accumulation, optional int8
gradient compression, remat through the model's layer loop; the port of
`repro/train/train_loop.py`.

`train_step(state, batch) -> (state, metrics)` is a function: it returns
a new `TrainState` of new tensors and leaves `state` as it was, so two
steps may start from one state (the straggler self-check does).  It runs
eagerly on the state's device; the JAX package jits it.
"""
from __future__ import annotations

import torch

from ..core.pytree import tree_flatten, tree_map
from ..models import model as M
from ..models.config import ArchConfig
from ..optim.optimizers import Optimizer
from .state import TrainState


def _int8_compress_decompress(g: torch.Tensor) -> torch.Tensor:
    """Simulated int8 gradient compression (quantize -> dequantize), as
    the JAX package computes it: the scale in the gradient's dtype (JAX's
    Python scalars are weak-typed, so a bf16 gradient has a bf16 scale),
    round half to even, clip to +-127, multiply back in float32."""
    floor = torch.full((), 1e-8, dtype=g.dtype, device=g.device)
    scale = torch.maximum(torch.max(torch.abs(g)), floor) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale.float()


def make_train_step(cfg: ArchConfig, opt: Optimizer, microbatches: int = 1,
                    compress_grads: bool = False):
    """Returns train_step(state, batch) -> (state, metrics)."""

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if microbatches > 1:
            def split(x):
                return x.reshape((microbatches, x.shape[0] // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: split(v) for k, v in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(microbatches):
                l, g = M.value_and_grad(cfg, state.params,
                                        {k: v[i] for k, v in mb.items()})
                loss = loss + l
                grads = tree_map(lambda a, b: a.add_(b), grads, g)
                del g
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        else:
            loss, grads = M.value_and_grad(cfg, state.params, batch)

        if compress_grads:
            grads = tree_map(_int8_compress_decompress, grads)

        new_params, new_opt = opt.update(grads, state.opt_state, state.params,
                                         state.step)
        metrics = {"loss": loss,
                   "grad_norm": _gnorm(grads),
                   "lr_step": state.step}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return train_step


def _gnorm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_flatten(grads)[0]))


def make_eval_step(cfg: ArchConfig):
    @torch.no_grad()
    def eval_step(params, batch):
        return M.loss_fn(cfg, params, batch)
    return eval_step
