"""TrainState tree and factory; the port of `repro/train/state.py`.

`TrainState.params` is the JAX package's parameter tree (nested dicts,
each layer stack one leaf with a leading layer axis: `models.convert.
to_reference`'s layout), so the optimizers see JAX's leaves and a
checkpoint of the state holds JAX's bytes.  `step` is a 0-d int32 tensor
on the parameters' device.  `from_reference_state` / `to_reference_state`
carry a JAX `TrainState` (as numpy: `jax.device_get(state)`) across and
back.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..core.pytree import tree_map
from ..models import model as M
from ..models.config import ArchConfig
from ..models.convert import _as_tensor, to_reference
from ..optim import make_optimizer, make_schedule
from ..optim.optimizers import Optimizer


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt_state: Any


def make_train_setup(cfg: ArchConfig, total_steps: int = 10000,
                     peak_lr: float = 3e-4) -> tuple[Optimizer, Any]:
    sched_kind = "wsd" if cfg.name.startswith("minicpm") else "cosine"
    lr = make_schedule(sched_kind, peak_lr, total_steps)
    opt = make_optimizer(cfg.optimizer, lr)
    return opt, lr


def init_state(cfg: ArchConfig, generator: torch.Generator | None,
               opt: Optimizer, device=None) -> TrainState:
    """Seeded parameters (`models.model.init_params`; `device` None means
    CUDA, raising without a card) in JAX's layout, and a fresh optimizer
    state."""
    model = M.init_params(cfg, generator, device)
    params = to_reference(model)
    dev = next(model.parameters()).device
    del model  # the stacked leaves are copies; the rest now live in params
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      opt.init(params))


def abstract_state(cfg: ArchConfig, opt: Optimizer) -> TrainState:
    """The state on the meta device: shapes and dtypes, no memory."""
    params = to_reference(M.init_params(cfg, device="meta"))
    return TrainState(torch.empty((), dtype=torch.int32, device="meta"),
                      params, opt.init(params))


def state_to(state: TrainState, device) -> TrainState:
    """Every leaf of `state` on `device` (a restored checkpoint comes back
    on the CPU)."""
    return tree_map(lambda t: t.to(device), state)


def from_reference_state(state, device=None) -> TrainState:
    """A JAX `TrainState` (numpy leaves, bf16 as `ml_dtypes.bfloat16`, or
    tensors) as the port's, on `device` (None means CUDA, raising without
    a card)."""
    from ..api.registry import resolve_device

    dev = resolve_device(device)
    step, params, opt_state = state
    return state_to(TrainState(_as_tensor(step),
                               tree_map(_as_tensor, params),
                               tree_map(_as_tensor, opt_state)), dev)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_reference_state(state: TrainState) -> TrainState:
    """The state with numpy leaves, the JAX package's dtypes (bf16 as
    `ml_dtypes.bfloat16`): what `jax.device_get` gives of a JAX state."""
    return tree_map(_as_numpy, state)
