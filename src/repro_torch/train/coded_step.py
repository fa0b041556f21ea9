"""Straggler-tolerant training via gradient coding (the `GradientCoder`
fractional-repetition scheme wired into a data-parallel step); the port
of `repro/train/coded_step.py`.

The global batch is cut into `coder.n_workers` parts along the batch axis;
group g's workers each report the gradient sum of all (s+1) parts owned
by g (bitwise-identical within a group by construction: the sum is formed
once, in fixed part order).  The decode is `decode_weights(alive)` applied
per step: the 0/1 weight vector selects one live representative per group
and the weighted cross-group sum is the EXACT full-batch gradient,
bitwise-equal in float to the all-alive step for any <= s stragglers,
because surviving reports enter the sum scaled by exactly 1.0.  More than
s stragglers in one group raises `RuntimeError` on the host, before any
device work.

Unlike the JAX step, which stacks the n per-part gradient trees, this one
keeps running sums: one group's float32 accumulator and the cross-group
total (one gradient tree is 3.44 GB at Qwen3-1.7B's width).  The dtypes
are JAX's: a group sum is rounded to the parameters' dtype, the weighted
total is float32.

Bitwise equality needs the same computation to give the same bits twice.
On CUDA the step runs under `torch.use_deterministic_algorithms(True)`
(the backward of an indexed gather would otherwise accumulate by atomics),
restored after the step.  PyTorch then refuses cuBLAS calls unless
`CUBLAS_WORKSPACE_CONFIG` is set; it is set to ":4096:8" here if unset.
cuBLAS reads it only when it starts (`launch/train.py` sets it first),
and on one stream its results repeat bit for bit either way.

Observability: every step lands a `coded_train_step` span on the installed
tracer (`obs.trace.get_tracer()`) with the straggler set as span args, and
the `coded_train_*` metrics family (steps/stragglers counters, per-step
wall-time histogram) feeds `obs.metrics.REGISTRY`.

Straggler patterns come from `StragglerInjector`: `FaultInjector`-driven
masks (each training step is one round of a virtual `RoundNetwork`): per
step `random` draws, `bursty` runs of a sticky victim set, or a `fixed`
worker set.  `launch/train.py --stragglers s` threads all of this end to
end.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..coding.gradient_code import GradientCoder
from ..core.pytree import tree_flatten, tree_map
from ..core.simulator import FaultInjector, RoundNetwork
from ..models import model as M
from ..models.config import ArchConfig
from ..obs import metrics, trace
from ..optim.optimizers import Optimizer
from .state import TrainState
from .train_loop import _gnorm

_STEPS = metrics.REGISTRY.counter(
    "coded_train_steps_total", "coded train steps run")
_STRAGGLED = metrics.REGISTRY.counter(
    "coded_train_stragglers_total", "worker-steps lost to stragglers")
_STEP_US = metrics.REGISTRY.histogram(
    "coded_train_step_us", "coded step wall time (host), us")


@contextlib.contextmanager
def deterministic(device: torch.device):
    """`torch.use_deterministic_algorithms(True)` for the block on a CUDA
    device (the CPU's kernels here are deterministic already)."""
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def make_straggler_train_step(cfg: ArchConfig, opt: Optimizer,
                              coder: GradientCoder):
    """Returns coded_step(state, batch, alive=None) -> (state, metrics).

    `batch` leaves must have a leading batch dim divisible by
    `coder.n_workers`; `alive` is a per-step (n_workers,) bool mask (None
    = all alive).  The returned metrics carry loss/grad_norm/lr_step like
    `make_train_step` plus the straggler count.  Gradient recovery is
    bitwise-exact vs the same step with `alive=None` for any <= s
    stragglers; > s in one group raises `RuntimeError` before dispatch.
    `state` is left as it was.
    """
    n = coder.n_workers
    G, m = coder.n_groups, coder.s + 1

    def _step(state: TrainState, batch: dict, gw: np.ndarray):
        parts = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        losses, total = [], None
        for g in range(G):
            # every worker of group g reports this sum; it is formed once,
            # over the group's parts in fixed order
            acc = None
            for j in range(g * m, (g + 1) * m):
                loss, grads = M.value_and_grad(
                    cfg, state.params, {k: v[j] for k, v in parts.items()})
                losses.append(loss)
                acc = (tree_map(lambda t: t.float(), grads) if acc is None
                       else tree_map(lambda a, t: a.add_(t), acc, grads))
                del grads
            gsum = tree_map(lambda a, p: a.to(p.dtype), acc, state.params)
            del acc
            # decode: sum_w a_w * report_w = sum_g (sum_{w in g} a_w) g_sum;
            # decode_weights puts exactly one 1.0 in each live group, so the
            # coefficient is exactly 1.0 (or the step was rejected on the
            # host) and the float combine is bitwise mask-independent
            w = float(gw[g])
            total = (tree_map(lambda t: t.float() * w, gsum) if total is None
                     else tree_map(lambda a, t: a.add_(t.float() * w), total,
                                   gsum))
            del gsum
        grads = tree_map(lambda t: t / n, total)
        del total
        loss = torch.mean(torch.stack(losses))
        new_params, new_opt = opt.update(grads, state.opt_state, state.params,
                                         state.step)
        metrics_out = {"loss": loss,
                       "grad_norm": _gnorm(grads),
                       "lr_step": state.step}
        return TrainState(state.step + 1, new_params, new_opt), metrics_out

    def coded_step(state: TrainState, batch: dict, alive=None):
        alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
        if alive.shape != (n,):
            raise ValueError(f"alive must be ({n},) bool, got {alive.shape}")
        b0 = tree_flatten(batch)[0][0].shape[0]
        if b0 % n:
            raise ValueError(f"batch dim {b0} not divisible by n_workers={n}")
        a = coder.decode_weights(alive)  # raises on > s in a group
        gw = a.reshape(G, m).sum(axis=1)
        stragglers = [int(w) for w in np.flatnonzero(~alive)]
        tracer = trace.get_tracer()
        t0 = time.perf_counter()
        with deterministic(state.step.device):
            out = _step(state, batch, gw)
        dur_us = (time.perf_counter() - t0) * 1e6
        if tracer is not None:
            tracer.complete("coded_train_step", tracer.now_us() - dur_us,
                            dur_us, pid="train", tid="coded_step",
                            cat="train.step",
                            args={"step": int(state.step),
                                  "stragglers": stragglers})
        _STEPS.inc(workers=n, s=coder.s)
        if stragglers:
            _STRAGGLED.inc(len(stragglers), workers=n, s=coder.s)
        _STEP_US.observe(dur_us, workers=n, s=coder.s)
        state2, mets = out
        mets = dict(mets)
        mets["stragglers"] = len(stragglers)
        return state2, mets

    return coded_step


@dataclass
class StragglerInjector:
    """Per-step straggler masks, `FaultInjector`-driven.

    Each training step is one round of a virtual `RoundNetwork`: the
    chosen pattern is registered up front through `FaultInjector.kill_at`
    (so `injector.plan` lists every (step, worker) straggle and the same
    chaos tooling as `launch/serve.py --chaos` applies), and `mask(step)`
    replays it as an alive mask for `make_straggler_train_step`.  Kills
    here are transient: a worker straggles the registered steps only,
    matching the gradient-coding fault model (slow, not dead).

    Patterns (all keep <= s victims per step, so every mask is decodable):
      random: each step straggles, with prob `rate`, a fresh uniform
              victim set of size 1..s
      bursty: a sticky victim set straggles for a geometric run of steps
              (mean `burst`), then a quiet gap, then a redraw
      fixed:  the given workers (default 0..s-1) straggle every step
    """

    coder: GradientCoder
    injector: FaultInjector
    _by_step: dict[int, frozenset] = dc_field(default_factory=dict)

    @property
    def plan(self) -> list:
        """The registered (step, worker) pairs, in registration order."""
        return self.injector.plan

    def mask(self, step: int) -> np.ndarray:
        alive = np.ones(self.coder.n_workers, bool)
        for w in self._by_step.get(int(step), ()):
            alive[w] = False
        return alive

    @classmethod
    def _new(cls, coder: GradientCoder) -> "StragglerInjector":
        net = RoundNetwork(coder.n_workers, p=1)
        return cls(coder, FaultInjector(net))

    def _register(self, step: int, victims) -> None:
        victims = frozenset(int(v) for v in victims)
        if victims:
            self.injector.kill_at(step, sorted(victims))
            self._by_step[int(step)] = victims

    @classmethod
    def random(cls, coder: GradientCoder, steps: int, *, rate: float = 0.3,
               seed: int = 0) -> "StragglerInjector":
        inj = cls._new(coder)
        rng = np.random.default_rng(seed)
        for t in range(steps):
            if rng.random() < rate:
                k = int(rng.integers(1, coder.s + 1)) if coder.s else 0
                inj._register(t, rng.choice(coder.n_workers, size=k,
                                            replace=False))
        return inj

    @classmethod
    def bursty(cls, coder: GradientCoder, steps: int, *, rate: float = 0.3,
               burst: int = 4, seed: int = 0) -> "StragglerInjector":
        inj = cls._new(coder)
        rng = np.random.default_rng(seed)
        t = 0
        while t < steps:
            if rng.random() < rate and coder.s:
                k = int(rng.integers(1, coder.s + 1))
                victims = rng.choice(coder.n_workers, size=k, replace=False)
                run = 1 + int(rng.geometric(1.0 / max(burst, 1)))
                for u in range(t, min(t + run, steps)):
                    inj._register(u, victims)
                t += run
            else:
                t += 1
        return inj

    @classmethod
    def fixed(cls, coder: GradientCoder, steps: int,
              workers=None) -> "StragglerInjector":
        workers = list(range(coder.s)) if workers is None else list(workers)
        if len(workers) > coder.s:
            raise ValueError(f"{len(workers)} fixed stragglers exceed "
                             f"tolerance s={coder.s}")
        inj = cls._new(coder)
        for t in range(steps):
            inj._register(t, workers)
        return inj

    @classmethod
    def build(cls, mode: str, coder: GradientCoder, steps: int, *,
              rate: float = 0.3, seed: int = 0) -> "StragglerInjector":
        if mode == "random":
            return cls.random(coder, steps, rate=rate, seed=seed)
        if mode == "bursty":
            return cls.bursty(coder, steps, rate=rate, seed=seed)
        if mode == "fixed":
            return cls.fixed(coder, steps)
        raise ValueError(f"unknown straggler mode {mode!r} "
                         "(random | bursty | fixed)")
