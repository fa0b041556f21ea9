"""Quickstart: train a small LM end-to-end with coded checkpointing; the
port of `examples/quickstart.py` on `repro_torch`.

    python examples_torch/quickstart.py                # on the card
    python examples_torch/quickstart.py --device cpu   # plain versions
    python examples_torch/quickstart.py --hundred-m    # ~100M params

Drives the same launcher used in production (repro_torch.launch.train)
with the JAX example's arguments and `--device`.  The checkpoints go to
a directory under the system's temporary directory.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ckpt_dir = str(Path(tempfile.gettempdir()) / "repro_torch_quickstart_ckpt")
    argv = ["quickstart", "--arch", "qwen3_1_7b", "--steps", "60",
            "--peak-lr", "5e-3", "--batch", "8", "--seq-len", "128",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "30",
            "--ckpt-shards", "8", "--ckpt-parity", "2"]
    if args.hundred_m:
        # ~100M params: widen the reduced config (trains for real; slower)
        argv += ["--d-model", "512", "--n-layers", "8", "--steps", "200"]
    sys.argv = argv + ["--device", args.device]
    from repro_torch.launch.train import main

    main()
