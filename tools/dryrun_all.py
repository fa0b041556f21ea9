#!/usr/bin/env python3
"""Every cell of the port's dry-run (`--all --mesh both`), a process each,
several at once; one line per cell and a summary.

    python3 tools/dryrun_all.py --out-dir results/dryrun_all --jobs 6

Each cell runs as `python -m repro_torch.launch.dryrun --arch A --shape S
--mesh M --force` with no card visible (the dry-run is host only) and a
time limit; the cell's JSON lands in --out-dir as the CLI writes it.
`--all --mesh both` runs the same cells one after another in one process.
Prints, per cell, the process's rc and wall, the trace seconds
(`lower_s`), `error` or `skipped`, the per-device FLOPs and the dominant
roofline term on the JAX package's TPU v5e model and on the H100's data
sheet; then the torch version, the count of cells that erred, were
skipped or timed out, and the largest `lower_s`.  Exits nonzero if a cell
erred or timed out.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def run_cell(cell, out_dir: str, limit_s: int) -> dict:
    arch, shape, mesh = cell
    t0 = time.perf_counter()
    try:
        rc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--out-dir", out_dir,
             "--force"], cwd=ROOT, capture_output=True, timeout=limit_s,
            env=dict(os.environ, PYTHONPATH=SRC,
                     CUDA_VISIBLE_DEVICES="")).returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    line = {"cell": f"{arch}__{shape}__{mesh}", "rc": rc,
            "wall_s": time.perf_counter() - t0}
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if rc != "timeout" and os.path.exists(path):
        with open(path) as f:
            res = json.load(f)
        line.update({
            "lower_s": res.get("lower_s"), "error": res.get("error"),
            "skipped": res.get("skipped"),
            "flops_per_device": res.get("hlo_flops_per_device"),
            "dominant_v5e": (res.get("roofline") or {}).get("dominant"),
            "dominant_h100": (res.get("roofline_h100") or {}).get("dominant")})
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="results/dryrun_all")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--limit-s", type=int, default=400)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch

    from repro_torch.configs import ARCH_IDS

    os.makedirs(args.out_dir, exist_ok=True)
    cells = [(a, s, m) for a in ARCH_IDS if a != "paper_rs" for s in SHAPES
             for m in ("single", "multi")]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        lines = list(pool.map(lambda c: run_cell(c, args.out_dir,
                                                 args.limit_s), cells))
    bad = [x["cell"] for x in lines if x["rc"] != 0 or x.get("error")]
    print(json.dumps({
        "torch": torch.__version__, "cells": len(lines),
        "erred_or_timed_out": bad,
        "skipped": sum(1 for x in lines if x.get("skipped")),
        "max_lower_s": max(x.get("lower_s") or 0 for x in lines),
        "wall_s": time.perf_counter() - t0, "jobs": args.jobs}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
