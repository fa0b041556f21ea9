"""Optimizers as pure (init, update) pairs over parameter trees (no
`torch.optim`); the port of `repro/optim/optimizers.py`.

* adamw     — float32 m/v states, decoupled weight decay.
* adafactor — factored second moment (row/col statistics for >=2D params),
              no first moment: ~1 byte-equivalent of state per parameter
              element.

Both clip by the global norm and take an `lr(step)` schedule callable.
A tree is a nest of dicts of tensors in the JAX package's layout (each
layer stack one leaf with a leading layer axis), walked in its leaf order
(`core.pytree`), so adafactor factors and RMS-clips the same leaves JAX
does.  `update` returns new tensors and leaves its arguments as they were.

The clipped float32 gradients are formed one leaf at a time inside the
update (JAX's `clip_by_global_norm` materialises them all): the same
values, and one leaf's copy in memory instead of the whole tree's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..core.pytree import flatten_up_to, tree_flatten, tree_map, tree_unflatten

Params = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params, Any], tuple[Params, Params]]
    # update(grads, state, params, step) -> (new_params, new_state)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_flatten(tree)[0]]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads, max_norm: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor every gradient is multiplied by, the global norm)."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _step_f32(step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


def adamw(
    lr: Callable,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        g_leaves, treedef = tree_flatten(grads)
        p_leaves = flatten_up_to(treedef, params)
        m_leaves = flatten_up_to(treedef, state["m"])
        v_leaves = flatten_up_to(treedef, state["v"])
        scale, _ = _clip_scale(grads, clip_norm)
        t = _step_f32(step, scale) + 1.0
        lr_t = lr(step)
        bc1 = 1 - b1**t
        bc2 = 1 - b2**t
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
            g = g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd_ = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            p32 = p.float()
            new_p.append((p32 - lr_t * (upd_ + weight_decay * p32)).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return (tree_unflatten(treedef, new_p),
                {"m": tree_unflatten(treedef, new_m),
                 "v": tree_unflatten(treedef, new_v)})

    return Optimizer(init, update)


def adafactor(
    lr: Callable,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    decay: float = 0.8,
    weight_decay: float = 0.0,
    clip_norm: float = 1.0,
) -> Optimizer:
    """Factored RMS optimizer (Shazeer & Stern 2018), momentum-free."""

    def _factored(p) -> bool:
        return p.ndim >= 2

    def init(params):
        def st(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"r": zeros(p.shape[:-1]),                  # row stats
                        "c": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return tree_map(st, params)

    def update(grads, state, params, step):
        g_leaves, treedef = tree_flatten(grads)
        p_leaves = flatten_up_to(treedef, params)
        s_leaves = flatten_up_to(treedef, state)
        scale, _ = _clip_scale(grads, clip_norm)
        t = _step_f32(step, scale) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = lr(step)
        new_p, new_s = [], []
        for g, s, p in zip(g_leaves, s_leaves, p_leaves):
            g = g.float() * scale
            g2 = g * g + eps
            if _factored(p):
                r = beta * s["r"] + (1 - beta) * torch.mean(g2, dim=-1)
                c = beta * s["c"] + (1 - beta) * torch.mean(g2, dim=-2)
                rc = r / torch.clamp(torch.mean(r, dim=-1, keepdim=True), min=eps)
                vhat = rc[..., None] * c[..., None, :]
                new_s.append({"r": r, "c": c})
            else:
                v = beta * s["v"] + (1 - beta) * g2
                vhat = v
                new_s.append({"v": v})
            u = g / torch.sqrt(vhat + eps)
            # update clipping (RMS)
            rms_u = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p32 = p.float()
            new_p.append((p32 - lr_t * (u + weight_decay * p32)).to(p.dtype))
        return tree_unflatten(treedef, new_p), tree_unflatten(treedef, new_s)

    return Optimizer(init, update)


def make_optimizer(kind: str, lr: Callable, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[kind](lr, **kw)
