"""Batched greedy serving demo (prefill + KV-cached decode), with the coded
parameter-shard self-check (unified encoding API) gating startup and the
batched coding queue coalescing concurrent encode/decode requests into
streamed plan executions (`--queue-demo`); the port of
`examples/serve_demo.py` on `repro_torch`.

    python examples_torch/serve_demo.py                # on the card
    python examples_torch/serve_demo.py --device cpu   # plain versions
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    sys.argv = ["serve_demo", "--arch", "mamba2_780m", "--batch", "4",
                "--prompt-len", "12", "--gen-len", "24", "--coded-selfcheck",
                "--queue-demo", "8"] + ["--device", device]
    from repro_torch.launch.serve import main

    main()
