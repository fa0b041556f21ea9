"""Fault-tolerance demo: train, kill 4 of 16 state shards mid-run, restore
from Reed-Solomon parity (the paper's decentralized encoding output), and
verify training continues bit-identically to an uninterrupted run.

The port of `examples/coded_checkpoint_restart.py` on `repro_torch`: the
model, its steps and the checkpoint's kernels run on `--device` (default
the card; `--device cpu` runs the kernels' plain versions).  On the card
both runs are under `torch.use_deterministic_algorithms`, so the same
steps give the same bits."""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch

from repro_torch.api.registry import resolve_device
from repro_torch.ckpt import CodedCheckpointer
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.train import init_state, make_train_setup, make_train_step
from repro_torch.train.state import state_to


def run(steps, ckpt=None, fail_at=None, fail_shards=frozenset()):
    cfg = get_config("qwen3_1_7b").smoke()
    opt, _ = make_train_setup(cfg, total_steps=steps, peak_lr=5e-3)
    state = init_state(cfg, torch.Generator(DEVICE).manual_seed(0), opt,
                       DEVICE)
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg.vocab, 64, 8)
    losses = []
    for i in range(steps):
        state, m = step(state, data.device_batch(i, DEVICE))
        losses.append(float(m["loss"]))
        if ckpt and (i + 1) % 10 == 0:
            ckpt.save(i + 1, state)
        if ckpt and fail_at == i:
            print(f"  !! shards {sorted(fail_shards)} lost at step {i}; "
                  f"reconstructing from RS parity...")
            s = ckpt.latest_step()
            # a restore comes back on the CPU: the state goes back to DEVICE
            state = state_to(ckpt.restore(s, state, failed_shards=fail_shards),
                             DEVICE)
            # rewind to the checkpoint step and replay (deterministic data)
            return losses[:s] + run_from(state, step, data, s, steps)
    return losses


def run_from(state, step, data, start, steps):
    losses = []
    for i in range(start, steps):
        state, m = step(state, data.device_batch(i, DEVICE))
        losses.append(float(m["loss"]))
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    DEVICE = resolve_device(ap.parse_args().device)
    if DEVICE.type == "cuda":  # the same steps, the same bits
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    with tempfile.TemporaryDirectory() as td:
        print("baseline run (no failures)...")
        base = run(30)
        print("run with 4/16 shard failures at step 17...")
        ck = CodedCheckpointer(td, n_shards=16, n_parity=4, device=DEVICE)
        recov = run(30, ckpt=ck, fail_at=17, fail_shards={2, 5, 11, 14})
        drift = max(abs(a - b) for a, b in zip(base, recov))
        print(f"max loss drift vs uninterrupted run: {drift:.2e}")
        assert drift < 1e-5, "coded restore must be exact"
        print("OK: training recovered bit-identically from 4 lost shards")
