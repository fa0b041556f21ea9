#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit, torch's device name);
2. builds both CUDA kernels from `src/repro_torch/csrc` (one nvcc each, in
   parallel) into the ignored `src/repro_torch/_build/`;
3. kernel phase: holds each kernel bitwise against its plain PyTorch version
   at the main path's shapes and at edge shapes, and times kernel, plain
   version and a one-call PyTorch yardstick with CUDA events;
4. main-path phase: `CodedSystem(CodeSpec(kind="rs", K=256, R=64))` on the
   card with a seeded (256, 2^18) payload: codeword -> fail 64 -> degraded
   read -> rebuild -> heal, checked bitwise; then a dense encode
   (universal 256/64) and a dft K=4096 encode, each checked against the
   exact numpy oracle;
5. prints the per-kernel JSON line and, last, the device JSON line.

Exits nonzero, printing no result, without a CUDA device, outside the
repository, or when any check fails.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
Q = 65537
SEED = 0
MAIN_W = 1 << 18      # payload width of the main path (README's stream size)
DFT_K = 4096          # the NTT kernel's largest transform
DFT_W = 1 << 12
CHECK_COLS = 4096     # columns held against the CPU and the numpy oracle

# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3, and
# 67 TFLOP/s of float32 on the CUDA cores = 128 FMA lanes per SM.  The Hopper
# SM has 64 INT32 lanes (Hopper architecture white paper), so integer
# multiply-adds peak at half the float32 FMA rate: 67e12 / 2 / 2 per second.
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(2)


def need(cond, msg) -> None:
    """An assert that `python -O` does not strip."""
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
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


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work (ms) and what sets it: the bytes moved over
    the memory rate, or the integer multiply-adds over the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_MAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(gen):
    """Hold both kernels against their plain versions; returns the summed
    figures of each kernel over the shapes the main path launches it at."""
    import torch

    from repro_torch.core.field import FERMAT
    from repro_torch.core.matrices import gauss_inverse, permuted_dft_matrix
    from repro_torch.kernels import gf_matmul, gf_matmul_plain, ntt, ntt_plain

    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randint(0, Q, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def full(*shape):
        return torch.full(shape, Q - 1, device=dev, dtype=torch.int32)

    worst = {"gf_matmul": 0, "ntt": 0}  # kernel vs plain version, per kernel

    def check(name, got, want, kernel=None):
        err = max_abs_err(got, want)
        if kernel is not None:
            worst[kernel] = max(worst[kernel], err)
        # exact field arithmetic: the tolerance is 0
        print(json.dumps({"check": name, "shape": list(got.shape),
                          "max_abs_err": err, "tolerance": 0}))
        need(err == 0, f"{name}: results differ (max abs err {err})")

    # -- edge shapes: ragged widths, the 65536 corner, deep accumulation ----
    for M, K, N in [(37, 300, 100003), (1, 1, 1)]:
        a, b = rnd(M, K), rnd(K, N)
        check(f"gf_matmul ragged {M}x{K}x{N}", gf_matmul(a, b),
              gf_matmul_plain(a, b), "gf_matmul")
    a, b = full(64, 4096), full(4096, 1000)
    check("gf_matmul all-65536", gf_matmul(a, b), gf_matmul_plain(a, b),
          "gf_matmul")
    a, b = full(8, 1 << 20), full(1 << 20, 130)
    check("gf_matmul all-65536 K=2^20", gf_matmul(a, b),
          gf_matmul_plain(a, b), "gf_matmul")
    for Z, C in [(4096, 1003), (2, 1001), (64, (1 << 20) + 5), (1, 7)]:
        x = rnd(Z, C)
        for inv in (False, True):
            check(f"ntt Z={Z} C={C} inverse={inv}", ntt(x, inverse=inv),
                  ntt_plain(x, inverse=inv), "ntt")
    x = full(64, 4096)
    for inv in (False, True):
        check(f"ntt all-65536 inverse={inv}", ntt(x, inverse=inv),
              ntt_plain(x, inverse=inv), "ntt")

    # -- main-path shapes, checked and timed --------------------------------
    W = 1 << 18
    rows = []
    for M, what in [(64, "repair: (64 x 256) . (256 x 2^18)"),
                    (256, "degraded read: (256 x 256) . (256 x 2^18)")]:
        a, b = rnd(M, 256), rnd(256, W)
        got = gf_matmul(a, b)
        check(f"gf_matmul {what}", got, gf_matmul_plain(a, b), "gf_matmul")

        def library(a=a, b=b):
            return torch.remainder(torch.matmul(a.double(), b.double()), Q)

        check(f"library yardstick {what}", library(), got)  # exact < 2^53
        nbytes = 4 * (M * 256 + 256 * W + M * W)
        rows.append(("gf_matmul", what, nbytes, M * 256 * W,
                     time_ms(lambda: gf_matmul(a, b), 20),
                     time_ms(lambda: gf_matmul_plain(a, b), 3),
                     time_ms(library, 5)))
    Z, C = 64, 4 * W
    D = permuted_dft_matrix(FERMAT, Z, 2)
    for inv, what in [(True, "inverse (64 x 2^20)"), (False, "forward (64 x 2^20)")]:
        x = rnd(Z, C)
        got = ntt(x, inverse=inv)
        check(f"ntt {what}", got, ntt_plain(x, inverse=inv), "ntt")
        mat = gauss_inverse(FERMAT, D) if inv else D
        dt = torch.as_tensor(mat.T.astype("float64"), device=dev)

        def library(x=x, dt=dt):
            return torch.remainder(dt @ x.double(), Q)

        check(f"library yardstick ntt {what}", library(), got)
        butterflies = Z // 2 * 6 * C
        ops = 3 * butterflies + (Z * C if inv else 0)  # mul, add, sub; scale
        rows.append(("ntt", what, 8 * Z * C + 4 * 6 * Z // 2, ops,
                     time_ms(lambda: ntt(x, inverse=inv), 50),
                     time_ms(lambda: ntt_plain(x, inverse=inv), 3),
                     time_ms(library, 5)))

    summary = {}
    for name, what, nbytes, ops, k_ms, p_ms, l_ms in rows:
        b_ms, b_by = bound(nbytes, ops)
        print(json.dumps({"kernel": name, "shape": what, "bytes": nbytes,
                          "int_ops": ops, "kernel_ms": k_ms, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": b_ms,
                          "bound_by": b_by}))
        s = summary.setdefault(name, {"shapes": [], "ms": 0.0, "plain_ms": 0.0,
                                      "library_ms": 0.0, "bound_ms": 0.0,
                                      "bound_by": b_by})
        s["shapes"].append(what)
        s["ms"] += k_ms
        s["plain_ms"] += p_ms
        s["library_ms"] += l_ms
        s["bound_ms"] += b_ms
    for name, s in summary.items():
        s["max_abs_err"] = worst[name]
    return summary


# ---------------------------------------------------------------------------
# main-path phase
# ---------------------------------------------------------------------------

LEGS = ("host_in", "h2d", "d2h", "host_out")  # run_on_device's other spans


def timed_op(system, name: str, fn):
    """Run one public operation; print its wall time split by the trace
    spans into host work, host->device copy, kernels (with the int64 glue
    between them) and device->host copy; `host_other_ms` is the rest of
    the operation (numpy slicing and concatenation in the session)."""
    tracer = system.tracer
    n0 = len(tracer.events())
    t0 = time.perf_counter()
    out = fn()
    wall = (time.perf_counter() - t0) * 1e3
    split = dict.fromkeys(LEGS + ("kernels",), 0.0)
    for ev in tracer.events()[n0:]:
        key = ev["name"] if ev["name"] in LEGS else "kernels"
        split[key] += ev["dur"] / 1e3
    line = {"op": name, "spec": f"{system.spec.kind} K={system.spec.K} "
            f"R={system.spec.R}", "wall_ms": wall}
    line.update({f"{k}_ms": v for k, v in split.items()})
    line["host_other_ms"] = wall - sum(split.values())
    print(json.dumps(line))
    return out


def oracle_parity(A, x):
    """x^T A over F_q on the host (numpy int64, exact)."""
    from repro_torch.core.field import FERMAT

    return FERMAT.matmul(A.T, x)


def main_path_phase():
    import numpy as np

    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.kernels import gf_matmul, ntt

    rng = np.random.default_rng(SEED)
    spec = CodeSpec(kind="rs", K=256, R=64)
    W, C = MAIN_W, CHECK_COLS
    x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
    dead = np.sort(np.concatenate([rng.choice(spec.K, 40, replace=False),
                                   spec.K + rng.choice(spec.R, 24,
                                                       replace=False)]))

    gf_matmul.launches = 0
    ntt.launches = 0
    t0 = time.perf_counter()
    system = CodedSystem(spec, backend="local", trace=True)
    print(json.dumps({"op": "plan_encode", "wall_ms":
                      (time.perf_counter() - t0) * 1e3}))
    plan = system.encode_plan
    need(plan.local_impl == "ntt", plan.local_impl)
    cw = timed_op(system, "codeword", lambda: system.codeword(x))
    system.fail(dead.tolist())
    t0 = time.perf_counter()
    _ = system.decode_plan
    print(json.dumps({"op": "plan_decode", "erased": len(dead), "wall_ms":
                      (time.perf_counter() - t0) * 1e3}))
    lost = cw.copy()
    lost[dead] = 0  # failed rows carry nothing
    x2 = timed_op(system, "read", lambda: system.read(lost))
    healed = timed_op(system, "rebuild", lambda: system.rebuild(lost))
    system.heal()
    launches = {"gf_matmul": gf_matmul.launches, "ntt": ntt.launches}
    system.close()
    need(np.array_equal(x2, x), "degraded read differs from the data")
    need(np.array_equal(healed, cw), "rebuild differs from the codeword")
    need(system.failed == (), system.failed)
    need(launches["ntt"] >= 2 and launches["gf_matmul"] >= 2, launches)
    cpu = CodedSystem(spec, backend="local", device="cpu")
    need(np.array_equal(cpu.codeword(x[:, :C]), cw[:, :C]),
         "card parity differs from the plain versions on the CPU")
    need(np.array_equal(oracle_parity(plan.A, x[:, :C]), cw[spec.K:, :C]),
         "parity differs from x^T A")
    print(json.dumps({"main_path": f"rs K=256 R=64 W={W}", "erased":
                      len(dead), "launches": launches, "read_exact": True,
                      "rebuild_exact": True}))

    # the other two encode routes: dense field matmul and a large dft
    for spec, W, impl, kernel in [
            (CodeSpec(kind="universal", K=256, R=64, seed=0), MAIN_W, "dense",
             gf_matmul),
            (CodeSpec(kind="dft", K=DFT_K, R=DFT_K), DFT_W, "ntt", ntt)]:
        x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
        before = kernel.launches
        system = CodedSystem(spec, backend="local", trace=True)
        need(system.encode_plan.local_impl == impl, spec)
        y = timed_op(system, "encode", lambda: system.encode(x))
        system.close()
        need(kernel.launches > before, f"{spec}: no {impl} kernel launch")
        need(y.shape == (spec.R, W), y.shape)
        need(np.array_equal(oracle_parity(system.encode_plan.A, x[:, :64]),
                            y[:, :64]), f"{spec}: parity differs from x^T A")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    print(card_line())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))
    t0 = time.perf_counter()
    logs = build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "built": sorted(logs)}))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")

    print(json.dumps({"peaks": {
        "hbm_bytes_per_s": HBM_BYTES_PER_S, "int32_mad_per_s": INT32_MAD_PER_S,
        "source": "H100 SXM data sheet (3.35 TB/s; 67 TFLOP/s float32 = 128 "
                  "FMA lanes/SM) and the Hopper white paper (64 INT32 "
                  "lanes/SM): INT32 multiply-adds at half the FMA rate"}}))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary = kernel_phase(gen)
    launches = main_path_phase()

    sources = {"gf_matmul": ("src/repro_torch/csrc/gf_matmul.cu",
                             "src/repro/kernels/gf_matmul.py:53"),
               "ntt": ("src/repro_torch/csrc/ntt.cu",
                       "src/repro/kernels/ntt.py:80")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"], "shapes": s["shapes"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
