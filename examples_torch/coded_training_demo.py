"""Training that keeps its step while workers straggle, and inference
that keeps its answers while workers die.

    coder = GradientCoder(n_workers=4, s=1)
    step = make_straggler_train_step(cfg, opt, coder)
    state, m = step(state, batch, alive)   # any <= s stragglers: exact

Walks the two coded-computation workloads end to end:

  1. Straggler-tolerant training — the global batch is cut across 4
     data-parallel workers per the fractional-repetition assignment
     (groups of s+1 sharing parts); each step decodes around an injected
     straggler mask and the recovered gradient is BITWISE-equal to the
     all-alive step, under random and bursty `StragglerInjector` patterns
     driven by the simulator's `FaultInjector`.
  2. Coded inference — a layer matmul Y = X @ W runs Lagrange-coded
     through a `CodedSystem` (`CodedMatmul`): K data shards + R parity
     workers; any <= R dropouts decode around via the recover/ stack,
     bitwise-exactly.

The port of `examples/coded_training_demo.py` on `repro_torch`: the
model, its steps and the coded matmul's kernels run on `--device`
(default the card; `--device cpu` runs the kernels' plain versions).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.api.registry import resolve_device
from repro_torch.coding import CodedMatmul, GradientCoder
from repro_torch.configs import get_config
from repro_torch.core.field import FERMAT
from repro_torch.core.pytree import tree_flatten
from repro_torch.data import SyntheticLM
from repro_torch.train import (StragglerInjector, init_state,
                               make_straggler_train_step, make_train_setup)

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args().device)

    # -- 1. straggler-tolerant training ----------------------------------
    cfg = get_config("qwen3_1_7b").smoke()
    opt, _ = make_train_setup(cfg, total_steps=20, peak_lr=3e-3)
    state = init_state(cfg, torch.Generator(device).manual_seed(0), opt,
                       device)
    data = SyntheticLM(cfg.vocab, seq_len=32, global_batch=8)

    coder = GradientCoder(n_workers=4, s=1)
    step = make_straggler_train_step(cfg, opt, coder)
    print(f"gradient coding: {coder.n_workers} workers in "
          f"{coder.n_groups} groups, s={coder.s} stragglers tolerated")

    # bitwise recovery: every <= s straggler pattern lands the exact
    # all-alive parameters
    batch = data.device_batch(0, device)
    ref, _ = step(state, batch)
    for dead in ([0], [1], [3]):
        alive = np.ones(4, bool)
        alive[dead] = False
        got, m = step(state, batch, alive)
        same = all(torch.equal(a, b)
                   for a, b in zip(tree_flatten(got.params)[0],
                                   tree_flatten(ref.params)[0]))
        assert same, dead
        print(f"  straggler {dead}: recovered gradient bitwise == all-alive "
              f"(loss {float(m['loss']):.4f})")

    # a short run under FaultInjector-driven patterns
    for mode in ("random", "bursty"):
        st, steps, straggled = state, 10, 0
        inj = StragglerInjector.build(mode, coder, steps, rate=0.6, seed=1)
        for t in range(steps):
            st, m = step(st, data.device_batch(t, device), inj.mask(t))
            straggled += m["stragglers"]
        print(f"  {mode:6s}: {steps} steps, {straggled} worker-steps "
              f"straggled ({len(inj.plan)} planned), "
              f"final loss {float(m['loss']):.4f}")

    # > s in one group is refused loudly, before the device step
    alive = np.ones(4, bool)
    alive[[0, 1]] = False  # group 0 wiped out
    try:
        step(state, batch, alive)
        raise SystemExit("should have raised")
    except RuntimeError as exc:
        print(f"  > s stragglers in a group: {exc}")

    # -- 2. coded inference (Lagrange-coded matmul) -----------------------
    print()
    rng = np.random.default_rng(0)
    K, R, b = 8, 4, 4
    X = FERMAT.rand((K * b, 64), rng)   # a layer's (quantized) activations
    W = FERMAT.rand((64, 32), rng)      # its weight shard
    truth = FERMAT.matmul(X, W)
    with CodedMatmul(K, R, device=device) as cm:
        print(f"coded matmul: K={K} data shards + R={R} parity workers "
              f"(backend={cm.backend})")
        for dead in ([], [3], [0, 9], [1, 5, 8, 11]):
            Y = cm(X, W, dead=dead)
            assert np.array_equal(Y, truth)
            print(f"  dropouts {dead or 'none'}: Y = X @ W recovered "
                  "bitwise-exactly")
    print()
    print("coded computation demo OK")
