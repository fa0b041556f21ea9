"""The port's dry-run at full size on the cells that took longest to trace:
a 32k prefill (the chunked attention's loops, counted once and scaled by
their trip counts) and a training step on the 2x16x16 multi-pod mesh
(the weight matmuls on each rank's shards), each as a subprocess of the
CLI under a 180 s limit, writing the JAX dry-run's JSON keys.  The
multi-pod cell's per-device FLOPs are half the single-mesh cell's: the
batch is split over pod x data = 32 ranks instead of 16.  Kept in a file
of its own, so that `--dist loadfile` gives these subprocesses a worker.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_torch_dryrun import _reference_keys

REPO = Path(__file__).resolve().parent.parent
LIMIT_S = 180


def _cell(tmp_path, arch, shape, mesh) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--out-dir", str(tmp_path),
         "--force"], capture_output=True, text=True, env=env,
        timeout=LIMIT_S, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    cell = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert "error" not in cell, cell.get("error")
    top, memory, roofline = _reference_keys()
    assert set(cell) == top | {"roofline_h100", "no_torch_analog"}
    assert set(cell["memory"]) == memory
    assert set(cell["roofline"]) == set(cell["roofline_h100"]) == roofline
    assert cell["lower_s"] < LIMIT_S
    assert cell["hlo_flops_per_device"] > cell["model_flops_per_device"] > 0
    return cell


def test_prefill_32k_cell(tmp_path):
    cell = _cell(tmp_path, "llava_next_mistral_7b", "prefill_32k", "single")
    assert cell["n_devices"] == 256
    # the chunked attention's score and value products are counted for
    # every (q chunk, kv chunk) pair: more than the model's matmuls
    assert cell["useful_ratio"] < 1


def test_multi_pod_train_cell(tmp_path):
    multi = _cell(tmp_path, "qwen3_1_7b", "train_4k", "multi")
    single = _cell(tmp_path, "qwen3_1_7b", "train_4k", "single")
    assert (multi["n_devices"], single["n_devices"]) == (512, 256)
    assert multi["model_flops_per_device"] * 2 == \
        single["model_flops_per_device"]
    assert multi["hlo_flops_per_device"] * 2 == \
        pytest.approx(single["hlo_flops_per_device"], rel=1e-3)
