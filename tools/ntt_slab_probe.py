#!/usr/bin/env python3
"""Where the slab NTT kernel's time goes on one NVIDIA GPU.

    python3 tools/ntt_slab_probe.py

Builds edited copies of `src/repro_torch/csrc/ntt.cu` with the package's nvcc
flags into the ignored `src/repro_torch/_build/probe/` and times each
variant's `ntt_slab` forward with CUDA events beside a device copy of the same
bytes, at Z = 4096, 1024 and 128 with 2^24 elements:

  as_is       the kernel as it is;
  threads256  blocks of 256 threads (at Z = 4096: 4 columns a block, two
              blocks an SM, half a 32-byte sector per warp row);
  memory      loads, shared-memory exchange and stores only (no stages, no
              twist): the floor of the kernel's memory structure;
  compute     no loads from device memory (values made from the indices):
              the arithmetic, the exchange and the stores.

`as_is` and `threads256` are held bitwise against `ntt_plain`.  Prints the
card's name and power limit, then one JSON line per (variant, Z).  Needs a
CUDA card and nvcc; exits nonzero without them.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
Q = 65537

LOAD_A = "live ? __ldcs(xb + (long long)(p + i * Z1 + a * Z2) * C) : 0u"
EDITS = {
    "as_is": [],
    "threads256": [("constexpr int SLAB_THREADS = 512;",
                    "constexpr int SLAB_THREADS = 256;")],
    "memory": [("      dif<L1, false>(v + i * Z1, tw.w1);\n", ""),
               ("    twist_row<Z2, false>(v, trow);\n", ""),
               ("    dif<L2, false>(v, tw.w2);\n", "")],
    "compute": [(LOAD_A,
                 "(uint32_t)((p * 977 + a * 13 + c * 31 + blockIdx.x) % 65537)")],
}


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_variants(build) -> dict:
    """{variant: its ntt_slab_launch}, one nvcc per variant, all at once."""
    src = (build.CSRC / "ntt.cu").read_text()
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out / f"ntt_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"lib{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).ntt_slab_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ntt_slab_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import importlib

    from repro_torch.kernels import build, ntt_plain

    mod = importlib.import_module("repro_torch.kernels.ntt")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fns = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for Z in (4096, 1024, 128):
        C = (1 << 24) // Z
        x = torch.randint(0, Q, (Z, C), generator=gen, device=dev,
                          dtype=torch.int32)
        out = torch.empty_like(x)
        root, scale = mod.roots(Z, False)
        tw, twist = mod._device_twist("slab", Z, root, scale, dev)

        def launch(fn):
            err = fn(x.data_ptr(), out.data_ptr(), twist.data_ptr(),
                     tw.ctypes.data, Z.bit_length() - 1, C, 1, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        want = ntt_plain(x)
        for name in ("as_is", "threads256"):
            launch(fns[name])
            if not torch.equal(out.long(), want):
                raise AssertionError(f"{name} differs from ntt_plain at Z={Z}")
        line = {"Z": Z, "C": C, "bound_ms": 8 * Z * C / 3.35e12 * 1e3,
                "copy_ms": time_ms(lambda: out.copy_(x))}
        for name, fn in fns.items():
            line[f"{name}_ms"] = time_ms(lambda fn=fn: launch(fn))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
