"""The port's mesh backend across 2, 4 and 8 gloo ranks on the CPU, bitwise
against one rank and the JAX package's simulator.  The ranks run in one
subprocess (`tests/torch_mesh_dist_checks.py`), which spawns them."""
import os
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_mesh_across_gloo_ranks_matches_one_rank_and_reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_mesh_dist_checks.py")],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    for G in (2, 4, 8):
        assert f"G={G}: every rank bitwise == G=1 == simulator" in proc.stdout
    assert "TORCH_MESH_DIST_CHECKS_OK" in proc.stdout
