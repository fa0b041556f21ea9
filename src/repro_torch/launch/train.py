"""Training launcher; the port of `repro/launch/train.py`.

    python -m repro_torch.launch.train --device cpu --steps 20
    python -m repro_torch.launch.train --stragglers 1 --coded-workers 4 \\
        --straggler-selfcheck --ckpt-dir /tmp/ck --fail-at 12,1,3

Trains the arch's reduced `.smoke()` config (`--full-config` for the
published one) on `--device` (default "cuda", which raises without a
card; "cpu" runs everything there, the kernels as their plain versions).
`train(state, step_fn, data, steps, ...)` is the loop for any config
(`chip_smoke.py` trains Qwen3-1.7B at full width and depth through it).

Fault tolerance:
  * coded checkpoints every --ckpt-every steps (background, RS parity
    across --ckpt-shards with --ckpt-parity tolerance: the NTT kernels
    encode it on the card); restart with --resume
  * simulated failure injection (--fail-at step,shard[,shard...]) restores
    with those data shards lost: a degraded read, repaired by the
    `gf_matmul` kernel
  * straggler-tolerant gradient coding (--stragglers s): the batch is cut
    across --coded-workers per the fractional-repetition assignment and
    every step decodes around the injected straggler mask
    (--straggler-mode random|bursty|fixed) with bitwise-exact gradients;
    --straggler-selfcheck asserts that against the all-alive step.
A restore comes back on the CPU; the state is moved to `--device` at once.

--production: in the JAX launcher the flag only prepends
--xla_force_host_platform_device_count=512 to XLA_FLAGS (512 host devices
for a production-mesh run); its step stays a plain `jax.jit`, so the
losses do not change.  Here it is accepted and changes nothing: torch has
no forced host devices, and the production meshes' shardings are traced
by `launch.dryrun` on a fake process group instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..core.pytree import tree_flatten
from ..obs.trace import host_span


@dataclass
class TrainResult:
    """What `train` fills in: the final state, the last step's metrics,
    every step's loss and wall (ending when its loss reached the host), the
    worker-steps decoded around, and each checkpoint operation as (op,
    step, seconds): "save" (the caller's part of a background save),
    "wait" (joining it), "final_save", "resume", "restore"."""

    state: object
    metrics: dict
    losses: list = dc_field(default_factory=list)
    step_s: list = dc_field(default_factory=list)
    straggled: int = 0
    ckpt_ops: list = dc_field(default_factory=list)


def _span(name: str, step: int):
    return host_span(name, "train", tid="launcher", cat="train.ckpt",
                     step=step)


def restore(ckpt, step: int, state, failed_shards=frozenset()):
    """`ckpt.restore` with the state moved back to its device."""
    from ..train.state import state_to

    restored = ckpt.restore(step, state, failed_shards=failed_shards)
    return state_to(restored, state.step.device)


def train(state, step_fn, data, steps: int, *, lr, ckpt=None,
          ckpt_every: int = 50, fail_step: int = -1,
          fail_shards=frozenset(), log_every: int = 10) -> TrainResult:
    """Steps `int(state.step)` .. `steps - 1` of `step_fn(state, batch, i)`
    on `data.device_batch(i)`, on the state's device: the JAX launcher's
    loop, with its checkpoints and its failure at `fail_step`."""
    device = state.step.device
    res = TrainResult(None, {})
    metrics: dict = {}
    t0 = time.time()
    start = int(state.step)
    for i in range(start, steps):
        t = time.perf_counter()
        state, metrics = step_fn(state, data.device_batch(i, device), i)
        res.losses.append(float(metrics["loss"]))  # waits for the step
        res.step_s.append(time.perf_counter() - t)
        res.straggled += int(metrics.get("stragglers", 0))
        if ckpt and (i + 1) % ckpt_every == 0:
            t = time.perf_counter()
            with _span("ckpt_save", i + 1):
                ckpt.save(i + 1, state, background=True)
            res.ckpt_ops.append(("save", i + 1, time.perf_counter() - t))
        if i == fail_step:
            print(f"!! simulating failure of shards {set(fail_shards)} at "
                  f"step {i}")
            t = time.perf_counter()
            ckpt.wait()
            res.ckpt_ops.append(("wait", i + 1, time.perf_counter() - t))
            s = ckpt.latest_step()
            t = time.perf_counter()
            with _span("ckpt_restore", s):
                state = restore(ckpt, s, state, fail_shards)
            res.ckpt_ops.append(("restore", s, time.perf_counter() - t))
            print(f"   reconstructed from parity; resumed at step {s}")
        if (i + 1) % log_every == 0 or i == start:
            dt = (time.time() - t0) / (i - start + 1)
            print(f"step {i + 1:5d} loss={res.losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(lr(i)):.2e} {dt * 1e3:.0f} ms/step", flush=True)
    if ckpt:
        t = time.perf_counter()
        with _span("ckpt_save", steps):
            ckpt.save(steps, state)
            ckpt.wait()
        res.ckpt_ops.append(("final_save", steps, time.perf_counter() - t))
    res.state, res.metrics = state, metrics
    return res


def _straggler_selfcheck(coded_fn, state, batch, mask, stragglers: int,
                         device: torch.device) -> None:
    """The straggled step's params against the all-alive step's, bitwise,
    from one state.  Only the first result's params are kept while the
    second step runs (at full width the state is 17 GB)."""
    if mask.all():  # make the check exercise a real straggle
        mask[:stragglers] = False
    cuda = device.type == "cuda"
    peaks = []
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    s_dead, _ = coded_fn(state, batch, mask)
    dead = tree_flatten(s_dead.params)[0]
    del s_dead
    if cuda:
        peaks.append(torch.cuda.max_memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    s_live, _ = coded_fn(state, batch)
    live = tree_flatten(s_live.params)[0]
    del s_live
    if cuda:
        peaks.append(torch.cuda.max_memory_allocated(device))
    if not all(torch.equal(a, b) for a, b in zip(dead, live)):
        raise AssertionError("straggler step diverged from all-alive step")
    peak = (f"; device peaks {peaks[0] / 1e9:.2f} / {peaks[1] / 1e9:.2f} GB"
            if cuda else "")
    print(f"selfcheck OK: step with stragglers "
          f"{[int(w) for w in np.flatnonzero(~mask)]} bitwise == all-alive"
          f"{peak}")


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--peak-lr", type=float, default=3e-3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override smoke width (e.g. 512 for a ~100M model)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-shards", type=int, default=16)
    ap.add_argument("--ckpt-parity", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", default=None,
                    help="step,shard[,shard...]: simulate node failures")
    ap.add_argument("--stragglers", type=int, default=0,
                    help="s > 0: gradient-coded step tolerating s "
                         "stragglers per step (requires (s+1) | workers)")
    ap.add_argument("--coded-workers", type=int, default=8,
                    help="data-parallel workers for --stragglers "
                         "(batch must divide evenly)")
    ap.add_argument("--straggler-mode", default="random",
                    choices=["random", "bursty", "fixed"])
    ap.add_argument("--straggler-rate", type=float, default=0.5)
    ap.add_argument("--straggler-seed", type=int, default=0)
    ap.add_argument("--straggler-selfcheck", action="store_true",
                    help="assert bitwise gradient recovery vs the "
                         "all-alive step before training")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, the state and the "
                         "coding sessions; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--production", action="store_true",
                    help="accepted for the JAX launcher's CLI; changes "
                         "nothing here (see the module docstring)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    from ..api.registry import resolve_device

    device = resolve_device(args.device)  # raises without a card
    if device.type == "cuda":  # read when cuBLAS starts (the coded step)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from ..ckpt import CodedCheckpointer
    from ..coding import GradientCoder
    from ..configs import get_config
    from ..data import SyntheticLM
    from ..train import (StragglerInjector, init_state,
                         make_straggler_train_step, make_train_setup,
                         make_train_step)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, d_ff=args.d_model * 3,
            head_dim=max(args.d_model // max(cfg.n_heads, 1), 8))
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)

    opt, lr = make_train_setup(cfg, total_steps=args.steps, peak_lr=args.peak_lr)
    state = init_state(cfg, torch.Generator(device).manual_seed(0), opt, device)
    n_params = sum(p.numel() for p in tree_flatten(state.params)[0])
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} params={n_params:,} device={device} ({where})")

    resumed = []
    ckpt = None
    if args.ckpt_dir:
        ckpt = CodedCheckpointer(args.ckpt_dir, args.ckpt_shards,
                                 args.ckpt_parity, device=device)
        if args.resume and ckpt.latest_step() is not None:
            s = ckpt.latest_step()
            t = time.perf_counter()
            state = restore(ckpt, s, state)
            resumed.append(("resume", s, time.perf_counter() - t))
            print(f"resumed from coded checkpoint step {s}")

    fail_step, fail_shards = -1, set()
    if args.fail_at:
        parts = [int(x) for x in args.fail_at.split(",")]
        fail_step, fail_shards = parts[0], set(parts[1:])

    data = SyntheticLM(cfg.vocab, args.seq_len, args.batch)
    straggle = None
    if args.stragglers > 0:
        coder = GradientCoder(args.coded_workers, s=args.stragglers)
        if args.batch % coder.n_workers:
            raise SystemExit(f"--batch {args.batch} must be divisible by "
                             f"--coded-workers {coder.n_workers}")
        coded_fn = make_straggler_train_step(cfg, opt, coder)
        straggle = StragglerInjector.build(
            args.straggler_mode, coder, args.steps,
            rate=args.straggler_rate, seed=args.straggler_seed)
        print(f"gradient coding: {coder.n_workers} workers, "
              f"s={coder.s} tolerated, {coder.n_groups} groups, "
              f"{args.straggler_mode} stragglers "
              f"({len(straggle.plan)} worker-step straggles planned)")
        if args.straggler_selfcheck:
            _straggler_selfcheck(coded_fn, state, data.device_batch(0, device),
                                 straggle.mask(0), args.stragglers, device)

        def step_fn(st, batch, i):
            return coded_fn(st, batch, straggle.mask(i))
    else:
        base_fn = make_train_step(cfg, opt, args.microbatches,
                                  args.compress_grads)

        def step_fn(st, batch, i):
            return base_fn(st, batch)

    # the loop holds the only reference to the state it starts from, so
    # each step's input is freed once the next state exists
    box = [state]
    del state
    result = train(box.pop(), step_fn, data, args.steps, lr=lr, ckpt=ckpt,
                   ckpt_every=args.ckpt_every, fail_step=fail_step,
                   fail_shards=fail_shards, log_every=args.log_every)
    result.ckpt_ops[:0] = resumed
    if straggle is not None:
        print(f"stragglers: {result.straggled} worker-steps decoded around "
              f"({args.straggler_mode}, s={args.stragglers})")
    if result.metrics:
        print(f"done: final loss {float(result.metrics['loss']):.4f}")
    else:
        print(f"done: no step to run (state at step {int(result.state.step)})")
    return result


if __name__ == "__main__":
    main()
