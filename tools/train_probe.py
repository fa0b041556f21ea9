#!/usr/bin/env python3
"""Where a training step's time and memory go, on one NVIDIA GPU.

    python3 tools/train_probe.py

Qwen3-1.7B at full width and depth (bf16, AdamW, remat; batch 8,
sequence 128), seeded on the card, through the port's own functions:

1. the plain train step, profiled over 2 steps after 2 warm-up steps: the
   device busy time a step from the device events' durations, beside the
   sum over `key_averages()` rows (which counts each kernel twice: under
   its own name and under the operator that launched it), device events a
   step, and the 12 kernels that take the most device time;
2. `value_and_grad` and the AdamW update, each timed twice: the host's
   time to enqueue it, and the time until the card has finished it;
3. `value_and_grad` at batch 2 (one part of the coded step) with and
   without `torch.use_deterministic_algorithms`;
4. the straggler-coded step (4 workers, s = 1): device memory allocated
   and its peak at the entry and exit of each part's `value_and_grad`,
   at the end of the step, and after the step's result is dropped.

Prints the card's name and power limit, then one JSON object a line.
Needs a CUDA card; imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

GB = 1e9


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.coding import GradientCoder
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import (init_state, make_straggler_train_step,
                                   make_train_setup, make_train_step)
    from repro_torch.train.coded_step import deterministic

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    cfg = get_config("qwen3_1_7b")
    opt, _ = make_train_setup(cfg, total_steps=20, peak_lr=3e-3)
    state = init_state(cfg, torch.Generator(device="cuda").manual_seed(0), opt)
    batch = SyntheticLM(cfg.vocab, 128, 8).device_batch(0)
    step = make_train_step(cfg, opt)

    # 1. the plain step's device time
    for _ in range(2):
        new, m = step(state, batch)
        float(m["loss"])
        del new, m
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            new, m = step(state, batch)
            float(m["loss"])
            del new, m
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.device_time / 1e3 / 2, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "plain_step": "Qwen3-1.7B, bf16, AdamW, remat, B=8, S=128",
        "busy_ms_per_step": sum(e.device_time for e in device) / 1e3 / 2,
        "key_averages_sum_ms_per_step":
            sum(a.self_device_time_total for a in prof.key_averages()) / 1e3 / 2,
        "device_events_per_step": len(device) / 2,
        "top_kernels": [{"name": k[:90], "ms_per_step": v[0], "per_step": v[1] / 2}
                        for k, v in top]}))

    # 2. host enqueue against completion
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        return out, host * 1e3, (time.perf_counter() - t) * 1e3

    for rep in range(2):
        (_, grads), vg_host, vg_total = timed(
            lambda: M.value_and_grad(cfg, state.params, batch))
        up, up_host, up_total = timed(
            lambda: opt.update(grads, state.opt_state, state.params, state.step))
        del up, grads
        print(json.dumps({"rep": rep, "value_and_grad_host_ms": vg_host,
                          "value_and_grad_total_ms": vg_total,
                          "update_host_ms": up_host, "update_total_ms": up_total}))

    # 3. one coded part, deterministic or not
    part = {k: v[:2] for k, v in batch.items()}
    cuda = torch.device("cuda")
    for det in (False, True, False, True):
        with deterministic(cuda) if det else contextlib.nullcontext():
            _, _, total = timed(lambda: M.value_and_grad(cfg, state.params, part))
        print(json.dumps({"value_and_grad_batch_2": True, "deterministic": det,
                          "total_ms": total}))

    # 4. the coded step's memory by stage
    marks = []

    def mark(what):
        torch.cuda.synchronize()
        marks.append([what, torch.cuda.memory_allocated() / GB,
                      torch.cuda.max_memory_allocated() / GB])

    plain_vg = M.value_and_grad

    def traced_vg(*args):
        mark("part in")
        out = plain_vg(*args)
        mark("part out")
        return out

    M.value_and_grad = traced_vg
    try:
        coded = make_straggler_train_step(cfg, opt, GradientCoder(4, s=1))
        torch.cuda.reset_peak_memory_stats()
        mark("start")
        new, m = coded(state, batch, np.array([True, False, True, True]))
        mark("end")
        del new, m
        mark("result dropped")
    finally:
        M.value_and_grad = plain_vg
    print(json.dumps({"coded_step_memory_gb": marks,
                      "columns": ["stage", "allocated", "peak"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
