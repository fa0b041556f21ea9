#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit, torch's device name);
2. builds both CUDA sources from `src/repro_torch/csrc` (one nvcc each, in
   parallel) into the ignored `src/repro_torch/_build/`, prints ptxas's
   register and spill lines and the count of integer tensor-core (IMMA)
   instructions in the gf_matmul library's SASS;
3. kernel phase: holds each kernel bitwise against its plain PyTorch version
   at the main path's shapes and at edge shapes, and times kernel, plain
   version and a one-call PyTorch yardstick with CUDA events;
4. main-path phase, four paths, each with the launch counts set to 0 just
   before and read just after: `CodedSystem(CodeSpec(kind="rs", K=256,
   R=64))` on the card with a seeded (256, 2^18) payload: codeword -> fail
   64 -> degraded read -> rebuild -> heal, checked bitwise; a dense encode
   (universal 256/64); a dft K=4096 and a dft K=8192 encode; each encode
   checked against the exact numpy oracle;
5. prints the per-kernel JSON line and, last, the device JSON line.

The kernels: `gf_matmul` (int8 tensor cores, 8-bit limbs), and behind the
one `ntt` wrapper `ntt` (the register kernel, Z <= 64), `ntt_slab` (two
register passes through shared memory, 64 < Z <= 4096, and the 4096-row
blocks above) and `ntt_outer` (the leading stages of 4096 < Z <= 2^16).

Exits nonzero, printing no result, without a CUDA device, outside the
repository, or when any check fails.  Imports nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
Q = 65537
SEED = 0
MAIN_W = 1 << 18      # payload width of the main path (README's stream size)
DFT_K = 4096          # the slab kernel's largest transform
DFT_W = 1 << 12
DFT_BIG_K = 8192      # the smallest transform above it (leading stages + slab)
BIG_CHECK_COLS = 16   # columns of the dft 8192 encode held against x^T A
CHECK_COLS = 4096     # columns held against the CPU and the numpy oracle

# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3,
# 1,979 T int8 tensor-core operations/s dense (989.5 T u8 multiply-adds), and
# 67 TFLOP/s of float32 on the CUDA cores = 128 FMA lanes per SM.  The Hopper
# SM has 64 INT32 lanes (Hopper architecture white paper), so integer
# multiply-adds on the CUDA cores peak at half the float32 FMA rate:
# 67e12 / 2 / 2 per second.
HBM_BYTES_PER_S = 3.35e12
INT8_MAC_PER_S = 1979e12 / 2
INT32_MAD_PER_S = 67e12 / 4
DESIGNS = {"gf_matmul": "imma-u8-limbs", "ntt": "ntt-registers",
           "ntt_slab": "ntt-two-register-passes",
           "ntt_outer": "ntt-leading-stages"}
SLAB_MAX_Z = 4096


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


def bound(nbytes: int, ops: int, rate: float) -> tuple[float, str]:
    """Least time for the work (ms) and what sets it: the bytes moved over
    the memory rate, or the operations over `rate`, their type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def imma_macs(a, b) -> int:
    """u8 multiply-adds the tensor-core kernel performs on these operands:
    four limb products per field multiply-add; two more for a's top limb in
    each 16-row x 32-deep tile of a that holds a 65536 (over all slabs of
    b); three more for b's top limb in each 32-deep x 128-column step of a
    slab that holds one (over all 32-row M-tiles)."""
    import torch.nn.functional as F

    M, K = a.shape
    N = b.shape[1]
    Mp, Np = -(-M // 32) * 32, -(-N // 128) * 128
    Kp = -(-K // 32) * 32
    ta = F.pad((a == Q - 1).float(), (0, Kp - K, 0, -(-M // 16) * 16 - M))
    tiles_a = int(F.max_pool2d(ta[None], (16, 32)).sum().item())
    tb = F.pad((b == Q - 1).float(), (0, Np - N, 0, Kp - K))
    tiles_b = int(F.max_pool2d(tb[None], (32, 128)).sum().item())
    return (4 * Mp * Kp * Np + 2 * tiles_a * 16 * 32 * Np
            + 3 * tiles_b * Mp * 32 * 128)


def sass_count(build, name: str, opcode: str) -> int:
    """Instructions of `opcode` in the built library's SASS (cuobjdump)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    # "/*addr*/ [@P0] OPCODE..."
    return len(re.findall(rf"\*/\s+(?:@!?U?P\w+\s+)?{opcode}\b", sass))


def max_abs_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max().item()) if got.numel() else 0


def dft_matrix(Z: int, inverse: bool, dev):
    """The (Z, Z) float64 matrix T with ntt(x, inverse) == T @ x mod q:
    forward T[k, j] = root^(j rev(k)) (the permuted DFT, transposed);
    inverse T[j, k] = Z^-1 root^-(j rev(k))."""
    import torch

    from repro_torch.kernels.ntt import roots

    root, scale = roots(Z, inverse)
    pw, acc = [], scale
    for _ in range(Z):
        pw.append(acc)
        acc = acc * root % Q
    H = Z.bit_length() - 1
    k = torch.arange(Z, device=dev)
    rev = sum(((k >> b) & 1) << (H - 1 - b) for b in range(H)) if H else k
    t = torch.as_tensor(pw, device=dev)[k[:, None] * rev[None, :] % Z]
    return (t if inverse else t.T).double().contiguous()


def outer_only(x, inverse: bool):
    """ntt_outer alone on x (Z > 4096) into a fresh output: the leading
    stages' share of the route above 4096, for timing."""
    import importlib

    import torch

    mod = importlib.import_module("repro_torch.kernels.ntt")
    Z = x.shape[0]
    root, scale = mod.roots(Z, inverse)
    out = torch.empty_like(x)
    mod._outer(x, out, Z, root, scale, inverse,
               torch.cuda.current_stream().cuda_stream)
    return out


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def kernel_phase(gen):
    """Hold every kernel against its plain version; returns the summed
    figures of each kernel over the shapes the main path launches it at."""
    import torch

    from repro_torch.kernels import gf_matmul, gf_matmul_plain, ntt, ntt_plain
    from repro_torch.kernels.ntt import REGS_MAX_Z

    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randint(0, Q, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def full(*shape):
        return torch.full(shape, Q - 1, device=dev, dtype=torch.int32)

    def ntt_names(Z):
        if Z <= REGS_MAX_Z:
            return ("ntt",)
        return ("ntt_slab",) if Z <= SLAB_MAX_Z else ("ntt_outer", "ntt_slab")

    worst = dict.fromkeys(DESIGNS, 0)  # kernel vs plain version, per kernel

    def check(name, got, want, kernels=()):
        err = max_abs_err(got, want)
        for kernel in kernels:
            worst[kernel] = max(worst[kernel], err)
        # exact field arithmetic: the tolerance is 0
        print(json.dumps({"check": name, "shape": list(got.shape),
                          "max_abs_err": err, "tolerance": 0}))
        need(err == 0, f"{name}: results differ (max abs err {err})")

    def gf_check(name, a, b):
        check(f"gf_matmul {name}", gf_matmul(a, b), gf_matmul_plain(a, b),
              ("gf_matmul",))

    # -- edge shapes: ragged M around the 32-row tiles, N off the 128-column
    # slab, K across the 256-deep chunk and the 16,384 flush, 65536 == -1 --
    for M, K, N in [(37, 300, 100003), (1, 1, 1), (1, 256, 1000),
                    (63, 256, 1000), (65, 256, 1000), (257, 256, 1000),
                    (5, 16385, 200), (4, 16384, 7), (3, 16383, 131)]:
        gf_check(f"ragged {M}x{K}x{N}", rnd(M, K), rnd(K, N))
    a, b = rnd(65, 256), rnd(256, 1000)
    b[100, 300] = Q - 1  # a single 65536 in one b tile
    gf_check("one 65536 in b", a, b)
    a = rnd(257, 256)
    a.view(-1)[torch.randperm(a.numel(), generator=gen, device=dev)[:999]] = Q - 1
    gf_check("-1 scattered over a", a, rnd(256, 1000))
    gf_check("all-65536", full(64, 4096), full(4096, 1000))
    gf_check("all-65536 K=2^20", full(8, 1 << 20), full(1 << 20, 130))
    # -- every Z the NTT takes up to 2^16, ragged widths, all-65536 ------
    for Z, C in [(4096, 1003), (2, 1001), (64, (1 << 20) + 5), (1, 7)] + [
            (1 << h, 1000 + 3 * h + 1) for h in range(17)]:
        x = rnd(Z, C)
        for inv in (False, True):
            check(f"ntt Z={Z} C={C} inverse={inv}", ntt(x, inverse=inv),
                  ntt_plain(x, inverse=inv), ntt_names(Z))
    for Z, C in [(64, 4096)] + [(1 << h, 257) for h in range(7, 17)]:
        x = full(Z, C)
        for inv in (False, True):
            check(f"ntt all-65536 Z={Z} inverse={inv}", ntt(x, inverse=inv),
                  ntt_plain(x, inverse=inv), ntt_names(Z))

    # -- main-path shapes, checked and timed --------------------------------
    W = 1 << 18
    rows = []
    for M, what in [(64, "repair: (64 x 256) . (256 x 2^18)"),
                    (256, "degraded read: (256 x 256) . (256 x 2^18)")]:
        a, b = rnd(M, 256), rnd(256, W)
        got = gf_matmul(a, b)
        check(f"gf_matmul {what}", got, gf_matmul_plain(a, b), ("gf_matmul",))

        def library(a=a, b=b):
            return torch.remainder(torch.matmul(a.double(), b.double()), Q)

        check(f"library yardstick {what}", library(), got)  # exact < 2^53
        nbytes = 4 * (M * 256 + 256 * W + M * W)
        rows.append(dict(
            name="gf_matmul", what=what, main=True, nbytes=nbytes,
            ops=imma_macs(a, b), rate=INT8_MAC_PER_S, mads=M * 256 * W,
            k_ms=time_ms(lambda: gf_matmul(a, b), 20),
            p_ms=time_ms(lambda: gf_matmul_plain(a, b), 3),
            l_ms=time_ms(library, 5)))
    # main = a shape a main path gives the kernel (summed into its entry of
    # the kernels line); above 4096 the row times the route (ntt_outer then
    # ntt_slab, the other way round for the inverse) and, apart, ntt_outer
    for Z, C, inv, main, what in [
            (64, 4 * W, True, True, "inverse (64 x 2^20)"),
            (64, 4 * W, False, True, "forward (64 x 2^20)"),
            (DFT_K, DFT_W, False, True, "forward (4096 x 2^12)"),
            (DFT_K, DFT_W, True, False, "inverse (4096 x 2^12)"),
            (DFT_BIG_K, DFT_W, False, True, "route forward (8192 x 2^12)"),
            (DFT_BIG_K, DFT_W, True, False, "route inverse (8192 x 2^12)"),
            (1 << 16, 1 << 10, False, False, "route forward (65536 x 2^10)"),
            (1 << 16, 1 << 10, True, False, "route inverse (65536 x 2^10)")]:
        x = rnd(Z, C)
        names = ntt_names(Z)
        got = ntt(x, inverse=inv)
        check(f"ntt {what}", got, ntt_plain(x, inverse=inv), names)
        library = None
        if Z <= DFT_BIG_K:  # the (Z, Z) float64 matrix: 512 MiB at 8192
            dt = dft_matrix(Z, inv, dev)

            def library(x=x, dt=dt):
                return torch.remainder(dt @ x.double(), Q)  # exact: < Z 2^32

            check(f"library yardstick ntt {what}", library(), got)
        H = Z.bit_length() - 1
        ops = 3 * (Z // 2 * H * C) + (Z * C if inv else 0)  # mul, add, sub; scale
        row = dict(name=names[0], what=what, main=main, nbytes=8 * Z * C,
                   ops=ops, rate=INT32_MAD_PER_S, mads=None,
                   k_ms=time_ms(lambda: ntt(x, inverse=inv), 30),
                   p_ms=time_ms(lambda: ntt_plain(x, inverse=inv), 3),
                   l_ms=time_ms(library, 3) if library else None)
        if Z > SLAB_MAX_Z:
            row["outer_ms"] = time_ms(lambda: outer_only(x, inv), 30)
        rows.append(row)
        del x, got, library

    summary = {}
    for r in rows:
        b_ms, b_by = bound(r["nbytes"], r["ops"], r["rate"])
        line = {"kernel": r["name"], "design": DESIGNS[r["name"]],
                "shape": r["what"], "main_path_shape": r["main"],
                "bytes": r["nbytes"], "ops": r["ops"], "kernel_ms": r["k_ms"],
                "plain_ms": r["p_ms"], "library_ms": r["l_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_share": b_ms / r["k_ms"]}
        if r["mads"] is not None:  # the same work on the CUDA cores' INT32 lanes
            line["int32_bound_ms"] = bound(r["nbytes"], r["mads"],
                                           INT32_MAD_PER_S)[0]
        if "outer_ms" in r:  # ntt_outer alone: one read and one write
            line["outer_ms"] = r["outer_ms"]
            line["outer_bound_share"] = b_ms / r["outer_ms"]
        print(json.dumps(line))
        if not r["main"]:
            continue
        s = summary.setdefault(r["name"], {"shapes": [], "ms": 0.0,
                                           "plain_ms": 0.0, "library_ms": 0.0,
                                           "bound_ms": 0.0, "bound_by": b_by})
        s["shapes"].append(r["what"])
        s["ms"] += r["k_ms"]
        s["plain_ms"] += r["p_ms"]
        s["library_ms"] += r["l_ms"]
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


def reset_counts() -> None:
    from repro_torch.kernels import gf_matmul, ntt

    gf_matmul.launches = 0
    ntt.launches = 0
    ntt.launches_by_kernel = dict.fromkeys(ntt.launches_by_kernel, 0)


def read_counts() -> dict:
    from repro_torch.kernels import gf_matmul, ntt

    return {"gf_matmul": gf_matmul.launches,
            "ntt": ntt.launches_by_kernel["registers"],
            "ntt_slab": ntt.launches_by_kernel["slab"],
            "ntt_outer": ntt.launches_by_kernel["outer"]}


def main_path_phase():
    """Returns each kernel's launches summed over the four paths, each
    path counted from 0 just before it to just after it."""
    import numpy as np

    from repro_torch.api import CodedSystem, CodeSpec

    rng = np.random.default_rng(SEED)
    spec = CodeSpec(kind="rs", K=256, R=64)
    W, C = MAIN_W, CHECK_COLS
    x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
    dead = np.sort(np.concatenate([rng.choice(spec.K, 40, replace=False),
                                   spec.K + rng.choice(spec.R, 24,
                                                       replace=False)]))

    reset_counts()
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
    launches = read_counts()
    system.close()
    need(np.array_equal(x2, x), "degraded read differs from the data")
    need(np.array_equal(healed, cw), "rebuild differs from the codeword")
    need(system.failed == (), system.failed)
    need(launches["ntt"] >= 2 and launches["gf_matmul"] >= 2, launches)
    total = dict(launches)
    cpu = CodedSystem(spec, backend="local", device="cpu")
    need(np.array_equal(cpu.codeword(x[:, :C]), cw[:, :C]),
         "card parity differs from the plain versions on the CPU")
    need(np.array_equal(oracle_parity(plan.A, x[:, :C]), cw[spec.K:, :C]),
         "parity differs from x^T A")
    print(json.dumps({"main_path": f"rs K=256 R=64 W={W}", "erased":
                      len(dead), "launches": launches, "read_exact": True,
                      "rebuild_exact": True}))

    # the other encode routes: dense field matmul and two large dfts
    for spec, W, impl, kernels, cols in [
            (CodeSpec(kind="universal", K=256, R=64, seed=0), MAIN_W, "dense",
             ("gf_matmul",), 64),
            (CodeSpec(kind="dft", K=DFT_K, R=DFT_K), DFT_W, "ntt",
             ("ntt_slab",), 64),
            (CodeSpec(kind="dft", K=DFT_BIG_K, R=DFT_BIG_K), DFT_W, "ntt",
             ("ntt_outer", "ntt_slab"), BIG_CHECK_COLS)]:
        x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
        reset_counts()
        system = CodedSystem(spec, backend="local", trace=True)
        need(system.encode_plan.local_impl == impl, spec)
        y = timed_op(system, "encode", lambda: system.encode(x))
        counts = read_counts()
        system.close()
        print(json.dumps({"path": f"encode {spec.kind} K={spec.K} R={spec.R} "
                          f"W={W}", "launches": counts}))
        for kernel in kernels:
            need(counts[kernel] >= 1, f"{spec}: no {kernel} kernel launch")
        need(y.shape == (spec.R, W), y.shape)
        need(np.array_equal(oracle_parity(system.encode_plan.A, x[:, :cols]),
                            y[:, :cols]), f"{spec}: parity differs from x^T A")
        for name, n in counts.items():
            total[name] += n
    return total


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
        for fn in re.split(r"Compiling entry function ", log)[1:]:
            regs = re.search(r"Used (\d+) registers", fn)
            spill = re.search(r"(\d+) bytes spill stores", fn)
            print(json.dumps({"ptxas": name, "kernel": fn.split("'")[1],
                              "registers": int(regs.group(1)),
                              "spill_store_bytes": int(spill.group(1))}))
    imma = sass_count(build, "gf_matmul", "IMMA")
    print(json.dumps({"sass": "gf_matmul", "imma_instructions": imma}))
    need(imma > 0, "no integer tensor-core instruction in gf_matmul's SASS")

    print(json.dumps({"peaks": {
        "hbm_bytes_per_s": HBM_BYTES_PER_S, "int8_mac_per_s": INT8_MAC_PER_S,
        "int32_mad_per_s": INT32_MAD_PER_S,
        "source": "H100 SXM data sheet (3.35 TB/s; 1,979 T int8 ops/s dense; "
                  "67 TFLOP/s float32 = 128 FMA lanes/SM) and the Hopper "
                  "white paper (64 INT32 lanes/SM): INT32 multiply-adds at "
                  "half the FMA rate"}}))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary = kernel_phase(gen)
    launches = main_path_phase()

    sources = {"gf_matmul": ("src/repro_torch/csrc/gf_matmul.cu",
                             "src/repro/kernels/gf_matmul.py:53"),
               "ntt": ("src/repro_torch/csrc/ntt.cu",
                       "src/repro/kernels/ntt.py:80"),
               "ntt_slab": ("src/repro_torch/csrc/ntt.cu",
                            "src/repro/kernels/ntt.py:80"),
               "ntt_outer": ("src/repro_torch/csrc/ntt.cu",
                             "src/repro/kernels/ntt.py:80")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = summary[name]
        need(launches[name] >= 1, f"{name}: not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"], "design": DESIGNS[name],
                        "bound_share": s["bound_ms"] / s["ms"],
                        "shapes": s["shapes"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
