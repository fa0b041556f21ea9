#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (`nvidia-smi` name and power limit, torch's device name);
2. builds the CUDA sources of `src/repro_torch/csrc` (one nvcc each, in
   parallel) into the ignored `src/repro_torch/_build/`, prints ptxas's
   register and spill lines, the count of integer tensor-core (IMMA)
   instructions in the gf_matmul library's SASS and of 64-bit
   multiply-adds (IMAD.WIDE.U32) in gf_matmul_small's, and one line per
   cluster size of `ntt_cluster` (blocks a cluster, shared bytes a block,
   columns, `cudaOccupancyMaxActiveClusters`, registers and spills);
3. kernel phase: holds each kernel bitwise against its plain PyTorch version
   at the main path's shapes and at edge shapes, and times kernel, plain
   version and a one-call PyTorch yardstick with CUDA events (for the NTT
   the (Z, Z) float64 DFT matrix, built on the card up to Z = 2^16; above
   Z = 4096 the one-pass cluster kernel, the forced two-pass route and
   `ntt_outer` alone in turns, at every Z from 2^13 to 2^16); then
   both designs of `gf_matmul_batched` (the CUDA-core `small` kernel and
   the tensor-core kernel's batched entry, each forced) at edge shapes and
   at a sweep of the mesh's combine shapes, 256 x (9 x 8).(8 x 2^18) among
   them, timed in turns beside the bound, the plain version and
   `torch.bmm` in float64, with the dispatch's pick beside the faster;
4. main-path phase, four paths, each with the launch counts set to 0 just
   before and read just after: `CodedSystem(CodeSpec(kind="rs", K=256,
   R=64))` on the card with a seeded (256, 2^18) payload: codeword -> fail
   64 -> degraded read -> rebuild -> heal, checked bitwise; a dense encode
   (universal 256/64); a dft K=4096 and a dft K=8192 encode; each encode
   checked against the exact numpy oracle;
4b. mesh phase (G = 1: all processors in one tensor on the card), each op
   with the launch counts set to 0 just before and read just after, and
   no plain version allowed to run: the same rs 256/64 chain on
   `backend="mesh"` (codeword -> fail 64 -> read -> rebuild -> heal), each
   output equal to the local backend's; a forced method="rs" encode (DFT
   butterflies), a dft K=4096 encode at W=2^12 and a commute=True rs
   256/64 encode on Topology(5, 64) (the generic IR lowering); per op the
   wall split by spans, the kernel spans by name, the launches, the peak
   device memory and the legs run;
5. stream phase, each op with the launch counts set to 0 just before and
   read just after: the same rs 256/64 session at W=2^18 with 64 seeded
   erasures through the device pipeline (copy stream, pinned buffers,
   events): `encode_stream` and `decode_stream` against the non-streamed
   `encode`/`decode`, `rebuild_stream` against the codeword, ragged
   `encode_batched` against per-payload `encode`, a burst of 24 queued
   `submit` futures against direct calls; per op its wall, chunk width,
   chunks, GB/s of int32 payload and, from the pipeline's CUDA events, how
   long chunk k+1's host->device copy overlapped chunk k's kernels (must be
   > 0 somewhere); then the chunk-width sweep (2^12 .. 2^18) of
   `encode_stream` and `decode_stream`;
6. simulator phase (host only): rs 16/4, universal, lagrange and dft specs
   of that order on the round-network simulator against the card's
   `local` values, measured C1/C2 against `plan.cost()`, zero drift;
   prints `describe()` and the keys of `stats()`;
7. solve phase: `core.parity.reconstruct` at rs K=256 R=64, W=2^18 from
   the 256 survivors of 64 seeded erasures, equal to the data; the
   256 x 256 Gauss-Jordan inverse on the card beside the host's
   `gauss_inverse`, equal;
8. checkpoint phase (examples/coded_checkpoint_restart.py's deployment:
   N=16, R=4, kills {2, 5, 11, 14}): a seeded bf16 state with the shapes
   of Qwen3-1.7B's first 4 decoder layers (of 28) on the card through
   `CodedCheckpointer`: save, background save + wait, healthy and degraded
   restores, in-place corruption, two scrubs, a last restore; every
   restore equal to the state byte for byte, every file's sha256 equal to
   the one recorded at save; per op its wall, GB/s of state bytes, chunk
   width and count, launches;
9. coding phase: `CodedMatmul` K=16 R=4 under one seeded dead set of each
   size 0-4, `LagrangeComputer` K=16 at degree 1 (N=20) and 2 (N=36) on
   seeded worker subsets, `GradientCoder(16, 3).combine` on float32 card
   trees of one decoder layer under all 256 one-per-group straggler
   patterns; all bitwise;
10. service phase: `CodedService` on the card at rs K=256 R=64, two
   tenants' client threads (32 encodes of (256, 4096) each) and a degraded
   read, then random `fail`s racing 36 queued encode/decode/rebuild
   submissions of two tenants; every future bitwise; coalescing ratio,
   failovers and p50/p99 latencies;
11. serve phase: the model server (`repro_torch.launch.serve`) on
   Qwen3-1.7B at full width and depth (28 layers, d_model 2048, vocab
   151936; 1,720,574,976 seeded bf16/float32 parameters on the card):
   the degraded coded self-check of the whole parameter tree (rs K=8 R=2:
   the NTT encodes, `gf_matmul` repairs and reads; bitwise) with its wall
   split by spans and the host's and the card's peak memory; the
   host-solve self-check (`reconstruct` -> `gf_solve` -> `gf_matmul`) of
   every arch's smoke-width tree, its codeword equal to the CPU's; greedy
   decode of B = 4 prompts of 16 tokens plus 32 new ones through
   `serve(...)`, ms per token and tokens/s beside the 1.027 ms weight-read
   bound, the profiler's device busy time and kernels a step; the step
   logits against one full forward over the same tokens (atol 0.15, rtol
   0.05, bf16); decode against forward for every arch at smoke width;
12. training phase (`repro_torch.launch.train`): Qwen3-1.7B at full width
   and depth (the same 1,720,574,976 parameters, 17.2 GB of state with
   AdamW's float32 moments), bf16, remat on: 20 steps at the JAX
   launcher's defaults (batch 8, sequence 128, peak LR 3e-3) through
   `train(...)`, each loss finite and the last below the first; the median
   ms per step and tokens/s beside the 14.3 ms FLOP bound,
   `value_and_grad` and the optimizer update timed alone, the profiler's
   device busy time and kernels a step, the device peak; microbatches=2
   against the full batch (rtol 2e-2) and one int8-compressed step; the
   straggler-coded step (`GradientCoder(4, s=1)`) at full width: run twice
   all-alive, bitwise equal, and with stragglers {0}, {1}, {3} bitwise the
   all-alive params, {0, 1} refused with no kernel launched; the
   launcher's failure-injection scenario with stragglers and self-check
   at smoke width (`main(LAUNCH_ARGV)`: the parity encode launches `ntt`,
   the degraded restore `gf_matmul`; the restored state on the card; per
   checkpoint op its wall and the spans by stage); one `value_and_grad`
   of every arch at smoke width, every gradient finite, the loss finite
   after one SGD step;
13. dist phase: (a) the port's dry-run (`repro_torch.launch.dryrun`), host
   only, in three subprocesses started together with no card visible:
   qwen3_1_7b x decode_32k and x train_4k on the 16x16 mesh, mamba2_780m x
   long_500k on the 2x16x16 multi-pod mesh (fake process groups of 256
   and 512 ranks, meta DTensors); per cell its per-device FLOPs, bytes and
   collective bytes by kind, the dominant term and both rooflines (the JAX
   package's TPU v5e model and the H100 data sheet); (b) `constrain` on
   the card: the training phase's full-width state, a batch and a decode
   cache as DTensors on a 1x1 ("data", "model") mesh of a one-rank NCCL
   group, placed by `dist.sharding`'s specs with `from_local` (no copy);
   `value_and_grad`, one train step and 8 greedy decode steps inside
   `activation_sharding`, under deterministic algorithms, the loss, every
   gradient, the new parameters and every decode logit bitwise the plain
   run's; ms per step and per token, DTensor beside plain, in turns;
14. prints the per-kernel JSON line (launches summed over every path) and,
   last, the device JSON line.

Each path of phases 4-13 is driven with the launch counts set to 0 just
before it and read just after.

The kernels: `gf_matmul` (int8 tensor cores, 8-bit limbs), `gf_matmul_batched`
(the mesh's per-processor combine: on the main path the CUDA-core kernel of
`csrc/gf_matmul_small.cu`; the tensor-core kernel's batched entry is its
other design, off the main path), and behind the
one `ntt` wrapper `ntt` (the register kernel, Z <= 64), `ntt_slab` (two
register passes through shared memory, 64 < Z <= 4096) and `ntt_cluster`
(one pass for 4096 < Z <= 2^16 on a thread-block cluster that exchanges
the leading stages through distributed shared memory).  The two-pass
route above 4096 (`ntt_outer`, the leading stages, then `ntt_slab` on each
4096-row block) is `ntt_cluster`'s other design: no main path takes it,
and it runs forced, for checks and timing.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
Q = 65537
SEED = 0
MAIN_W = 1 << 18      # payload width of the main path (README's stream size)
DFT_K = 4096          # the slab kernel's largest transform
DFT_W = 1 << 12
DFT_BIG_K = 8192      # the smallest transform above it (the cluster kernel)
BIG_CHECK_COLS = 16   # columns of the dft 8192 encode held against x^T A
CHECK_COLS = 4096     # columns held against the CPU and the numpy oracle
SWEEP_W = [1 << h for h in range(12, 19)]   # chunk widths of the sweep
BATCH_W = [1, 4095, 70000]                  # ragged encode_batched widths
SIM_W = 1024          # payload width of the simulator phase
SOLVE_W = MAIN_W      # payload width of the solve phase's reconstruct
CKPT_LAYERS = 4       # decoder layers of Qwen3-1.7B in the checkpoint state
CKPT_KILLS = (2, 5, 11, 14)  # examples/coded_checkpoint_restart.py's kills
CM_ROWS = 64          # rows per shard of the coded matmul (X: 16*64 x 2048)
LCC_W = 4096          # payload width of the Lagrange coded computation
SVC_W = 4096          # payload width of the service phase's requests
SVC_REQUESTS = 32     # encodes per client thread in the service phase
MESH_DFT_K = 4096     # the mesh phase's dft encode (butterfly rounds)
MESH_COMMUTE_TOPO = (5, 64)  # 320 slots for rs 256/64; 5 hosts do not
                             # divide K: a flat mesh, and the rewrite fires
SERVE_ARCH = "qwen3_1_7b"  # the serve phase's model, full width and depth
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32  # the JAX CLI's defaults
QWEN3_PARAMS = 1_720_574_976
QWEN3_BYTES = 3_441_397_760  # bf16 weights, float32 norms
DEC_ATOL, DEC_RTOL = 0.15, 0.05  # decode vs forward in bf16 (tests/test_archs.py)
# the training phase: the JAX launcher's defaults (batch 8, sequence 128,
# peak LR 3e-3), 20 AdamW steps of Qwen3-1.7B at full width and depth
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 20, 8, 128, 3e-3
QWEN3_STATE_BYTES = QWEN3_BYTES + 2 * 4 * QWEN3_PARAMS + 4  # + AdamW m, v; step
BF16_FLOP_PER_S = 989e12  # H100 SXM data sheet, dense bf16, 700 W
# the launcher's failure-injection scenario (tests/test_launch.py), smoke
# width, plus the straggler-coded step and its self-check
LAUNCH_ARGV = ["--steps", "25", "--ckpt-every", "10", "--fail-at", "12,1,3",
               "--peak-lr", "5e-3", "--seq-len", "64", "--batch", "4",
               "--stragglers", "1", "--coded-workers", "4",
               "--straggler-selfcheck", "--device", "cuda"]
# the dist phase: (a) the port's dry-run, host only, on three cells of the
# JAX package's launcher tests and its training cell; (b) constrain on the
# card: one DTensor train step and DIST_DECODE greedy decode steps
DRYRUN_CELLS = [("qwen3_1_7b", "decode_32k", "single"),
                ("qwen3_1_7b", "train_4k", "single"),
                ("mamba2_780m", "long_500k", "multi")]
DIST_DECODE = 8
DIST_BACKEND, DIST_MESH_DEVICE = "nccl", "cuda"
CARD = ""             # nvidia-smi's name and power limit, set by main()

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
           "ntt_cluster": "ntt-cluster-dsmem-one-pass",
           "ntt_outer": "ntt-leading-stages",
           "gf_matmul_batched": "cuda-cores-persistent-small-mk",
           "gf_matmul_batched_imma": "imma-u8-limbs-batched"}
# gf_matmul_batched's designs: its wrapper's names -> DESIGNS' names
BATCHED_DESIGNS = {"small": DESIGNS["gf_matmul_batched"],
                   "imma": DESIGNS["gf_matmul_batched_imma"]}
# (B, M, K, N, main path): the mesh's combines at W = 2^18 (rs 16/4, rs
# 64/16, rs 256/64 and rs 128/64), and deeper ones with b about 2 GB
BATCHED_SWEEP = [(16, 3, 2, MAIN_W, False), (64, 5, 4, MAIN_W, False),
                 (256, 9, 8, MAIN_W, True), (128, 9, 8, MAIN_W, False),
                 (1024, 17, 16, 1 << 15, False), (4096, 33, 32, 1 << 12, False)]
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


def card_state() -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    values = out.strip().splitlines()[0].split(", ")

    def num(v):  # "[N/A]" stays text
        try:
            return float(v)
        except ValueError:
            return v
    return {k: num(v) for k, v in zip(("sm_mhz", "power_w", "temp_c"), values)}


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


def dft_matrix(Z: int, inverse: bool, dev, rows: int = 1024):
    """The (Z, Z) float64 matrix T with ntt(x, inverse) == T @ x mod q:
    forward T[k, j] = root^(j rev(k)) (the permuted DFT, transposed);
    inverse T[j, k] = Z^-1 root^-(j rev(k)).  Built on the card in chunks of
    `rows` rows straight into float64 (34.4 GB at Z = 2^16; an int64
    index of the whole would double that)."""
    import torch

    from repro_torch.kernels.ntt import roots

    root, scale = roots(Z, inverse)
    pw, acc = [], scale
    for _ in range(Z):
        pw.append(acc)
        acc = acc * root % Q
    pw = torch.as_tensor(pw, dtype=torch.float64, device=dev)
    H = Z.bit_length() - 1
    k = torch.arange(Z, device=dev)
    rev = sum(((k >> b) & 1) << (H - 1 - b) for b in range(H)) if H else k
    t = torch.empty((Z, Z), dtype=torch.float64, device=dev)
    for r0 in range(0, Z, rows):
        r = k[r0:r0 + rows]
        idx = r[:, None] * rev[None, :] if inverse else rev[r, None] * k[None, :]
        t[r0:r0 + rows] = pw[idx % Z]
    return t


def cluster_lines(logs: dict) -> None:
    """Print one line per Z (cluster size) of `ntt_cluster`: blocks a
    cluster, shared bytes a block, columns a cluster, threads, and per
    direction `cudaOccupancyMaxActiveClusters`, registers and local bytes
    (from the runtime) beside ptxas's registers and spill stores (from this
    run's build log, where it built ntt.cu)."""
    import importlib

    mod = importlib.import_module("repro_torch.kernels.ntt")
    ptxas = {}
    for fn in re.split(r"Compiling entry function ", logs.get("ntt", ""))[1:]:
        args = re.search(r"ntt_cluster\w*?ILi(\d)ELi(\d)ELb([01])E",
                         fn.split("'")[1])
        if args:  # (blocks a cluster, rows, inverse)
            key = (1 << int(args.group(1)), 64 << int(args.group(2)),
                   args.group(3) == "1")
            ptxas[key] = {
                "ptxas_registers": int(re.search(r"Used (\d+) registers", fn).group(1)),
                "ptxas_spill_store_bytes": int(
                    re.search(r"(\d+) bytes spill stores", fn).group(1))}
    for Z, rows in mod.CLUSTER_ROWS.items():
        f = mod.cluster_config(Z)
        for d in ("forward", "inverse"):
            f[d].update(ptxas.get((Z // rows, rows, d == "inverse"), {}))
            need(f[d]["max_active_clusters"] >= 1,
                 f"ntt_cluster Z={Z}: no cluster of {f['cluster_blocks']} fits")
        print(json.dumps({"ntt_cluster_config": {"Z": Z, "rows": rows, **f}}))


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

    def ntt_names(Z, forced=None):
        """The kernels a Z-point transform launches (`forced`: a route)."""
        if Z <= REGS_MAX_Z:
            return ("ntt",)
        if Z <= SLAB_MAX_Z:
            return ("ntt_slab",)
        if forced != "two-pass":
            return ("ntt_cluster",)
        return ("ntt_outer", "ntt_slab")

    worst = dict.fromkeys(DESIGNS, 0)  # kernel vs plain version, per kernel
    worst["two-pass"] = 0              # the forced route above 4096

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
    def route_turns(x, Z, inv):
        """The cluster kernel, the two-pass route (each forced) and
        ntt_outer alone, in turns (cluster, two-pass, outer, outer,
        two-pass, cluster) after a warm-up; and the card's state before."""
        order = ("cluster", "two-pass", "outer", "outer", "two-pass", "cluster")
        turns = {k: [] for k in order}
        time_ms(lambda: ntt(x, inverse=inv), 10)  # warm-up, not kept
        state = card_state()
        for turn in order:
            turns[turn].append(time_ms(
                (lambda: outer_only(x, inv)) if turn == "outer" else
                (lambda t=turn: ntt(x, inverse=inv, _route=t)), 30))
        return turns, state

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
    # the kernels line); above 4096 the row times, in turns, the cluster
    # kernel, the forced two-pass route (ntt_outer then ntt_slab, the other
    # way round for the inverse) and ntt_outer alone
    for Z, C, inv, main, what in [
            (64, 4 * W, True, True, "inverse (64 x 2^20)"),
            (64, 4 * W, False, True, "forward (64 x 2^20)"),
            (DFT_K, DFT_W, False, True, "forward (4096 x 2^12)"),
            (DFT_K, DFT_W, True, False, "inverse (4096 x 2^12)"),
            (DFT_BIG_K, DFT_W, False, True, "route forward (8192 x 2^12)"),
            (DFT_BIG_K, DFT_W, True, False, "route inverse (8192 x 2^12)"),
            (1 << 14, 1 << 11, False, False, "route forward (16384 x 2^11)"),
            (1 << 14, 1 << 11, True, False, "route inverse (16384 x 2^11)"),
            (1 << 15, 1 << 11, False, False, "route forward (32768 x 2^11)"),
            (1 << 15, 1 << 11, True, False, "route inverse (32768 x 2^11)"),
            (1 << 16, 1 << 10, False, False, "route forward (65536 x 2^10)"),
            (1 << 16, 1 << 10, True, False, "route inverse (65536 x 2^10)")]:
        x = rnd(Z, C)
        names = ntt_names(Z)
        got = ntt(x, inverse=inv)
        check(f"ntt {what}", got, ntt_plain(x, inverse=inv), names)
        # above 4096 both routes in turns before the float64 yardstick (the
        # state of a card that the main path's host work leaves idle) and
        # again after it (the library's products heat the card)
        cool = route_turns(x, Z, inv) if Z > SLAB_MAX_Z else None
        torch.cuda.reset_peak_memory_stats()
        dt = dft_matrix(Z, inv, dev)  # 34.4 GB at Z = 2^16

        def library(x=x, dt=dt):
            return torch.remainder(dt @ x.double(), Q)  # exact: < Z 2^32 < 2^53

        check(f"library yardstick ntt {what}", library(), got)
        H = Z.bit_length() - 1
        ops = 3 * (Z // 2 * H * C) + (Z * C if inv else 0)  # mul, add, sub; scale
        row = dict(name=names[0], what=what, main=main, nbytes=8 * Z * C,
                   ops=ops, rate=INT32_MAD_PER_S, mads=None,
                   k_ms=time_ms(lambda: ntt(x, inverse=inv), 30),
                   p_ms=time_ms(lambda: ntt_plain(x, inverse=inv), 3),
                   l_ms=time_ms(library, 3),
                   library_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if Z > SLAB_MAX_Z:
            row["turns_ms"], row["card_before"] = cool
            row["after_library"] = dict(zip(("turns_ms", "card"),
                                            route_turns(x, Z, inv)))
            row["k_ms"] = sum(row["turns_ms"]["cluster"]) / 2  # the main path's
        rows.append(row)
        del x, got, library, dt
        torch.cuda.empty_cache()

    # -- above 4096 each route forced: the cluster kernel at ragged widths
    # around its 8-column clusters, the two-pass route; all-65536 (after the
    # timed rows, so that their plain versions' load precedes no timing) --
    for h in range(13, 17):
        Z = 1 << h
        for kind, widths in (("cluster", (1, 97, 4099)),
                             ("two-pass", (1000 + 3 * h + 1,))):
            for C in widths:
                for x, what in ((rnd(Z, C), f"C={C}"), (full(Z, 257), "all-65536")):
                    for inv in (False, True):
                        check(f"ntt {kind} Z={Z} {what} inverse={inv}",
                              ntt(x, inverse=inv, _route=kind),
                              ntt_plain(x, inverse=inv),
                              ntt_names(Z, kind) + (kind,) * (kind == "two-pass"))

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
        if "library_peak_gb" in r:  # the card's peak while the yardstick ran
            line["library_peak_gb"] = r["library_peak_gb"]
        if "turns_ms" in r:  # above 4096: both routes and ntt_outer alone
            means = {k: sum(v) / len(v) for k, v in r["turns_ms"].items()}
            line.update(turns_ms=r["turns_ms"], card_before=r["card_before"],
                        faster=min(("cluster", "two-pass"), key=means.get),
                        bound_shares={k: b_ms / v for k, v in means.items()})
            after = {k: sum(v) / len(v)
                     for k, v in r["after_library"]["turns_ms"].items()}
            line["after_library"] = {**r["after_library"], "faster": min(
                ("cluster", "two-pass"), key=after.get)}
            r["means"] = means
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
        if "means" in r:  # the main path's route beside the forced other one
            s["designs"] = {
                "cluster": {"design": DESIGNS["ntt_cluster"],
                            "ms": r["means"]["cluster"],
                            "bound_share": b_ms / r["means"]["cluster"],
                            "max_abs_err": worst["ntt_cluster"]},
                "two-pass": {"design": f'{DESIGNS["ntt_outer"]} + '
                                       f'{DESIGNS["ntt_slab"]}',
                             "ms": r["means"]["two-pass"],
                             "outer_ms": r["means"]["outer"],
                             "bound_share": b_ms / r["means"]["two-pass"],
                             "max_abs_err": worst["two-pass"]}}
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
    spans: dict = {}
    for ev in tracer.events()[n0:]:
        key = ev["name"] if ev["name"] in LEGS else "kernels"
        split[key] += ev["dur"] / 1e3
        if key == "kernels":
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    line = {"op": name, "spec": f"{system.spec.kind} K={system.spec.K} "
            f"R={system.spec.R}", "backend": system.backend, "wall_ms": wall}
    line.update({f"{k}_ms": v for k, v in split.items()})
    line["host_other_ms"] = wall - sum(split.values())
    line["kernel_spans_ms"] = spans
    print(json.dumps(line))
    return out


def oracle_parity(A, x):
    """x^T A over F_q on the host (numpy int64, exact)."""
    from repro_torch.core.field import FERMAT

    return FERMAT.matmul(A.T, x)


def reset_counts() -> None:
    from repro_torch.kernels import gf_matmul, gf_matmul_batched, ntt

    gf_matmul.launches = 0
    gf_matmul_batched.launches = 0
    gf_matmul_batched.launches_by_design = dict.fromkeys(
        gf_matmul_batched.launches_by_design, 0)
    ntt.launches = 0
    ntt.launches_by_kernel = dict.fromkeys(ntt.launches_by_kernel, 0)


def read_counts() -> dict:
    from repro_torch.kernels import gf_matmul, gf_matmul_batched, ntt

    by_design = gf_matmul_batched.launches_by_design
    need(gf_matmul_batched.launches == sum(by_design.values()), by_design)
    return {"gf_matmul": gf_matmul.launches,
            "ntt": ntt.launches_by_kernel["registers"],
            "ntt_slab": ntt.launches_by_kernel["slab"],
            "ntt_cluster": ntt.launches_by_kernel["cluster"],
            "ntt_outer": ntt.launches_by_kernel["outer"],
            "gf_matmul_batched": by_design["small"],
            "gf_matmul_batched_imma": by_design["imma"]}


def main_path_phase():
    """Returns each kernel's launches summed over the four paths, each
    path counted from 0 just before it to just after it."""
    from repro_torch.api import CodedSystem, CodeSpec

    rng = np.random.default_rng(SEED)
    spec = CodeSpec(kind="rs", K=256, R=64)
    W, C = MAIN_W, CHECK_COLS
    x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
    dead = seeded_erasures(rng, spec.K, spec.R)

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

    # the other encode routes: dense field matmul and two large dfts (the
    # dft 8192 encode: exactly one one-pass cluster launch, no two-pass)
    for spec, W, impl, kernels, cols in [
            (CodeSpec(kind="universal", K=256, R=64, seed=0), MAIN_W, "dense",
             ("gf_matmul",), 64),
            (CodeSpec(kind="dft", K=DFT_K, R=DFT_K), DFT_W, "ntt",
             ("ntt_slab",), 64),
            (CodeSpec(kind="dft", K=DFT_BIG_K, R=DFT_BIG_K), DFT_W, "ntt",
             {"ntt_cluster": 1, "ntt_outer": 0, "ntt_slab": 0}, BIG_CHECK_COLS)]:
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
            if isinstance(kernels, dict):  # exact counts
                need(counts[kernel] == kernels[kernel],
                     f"{spec}: {counts[kernel]} {kernel} launches, not "
                     f"{kernels[kernel]}")
            else:
                need(counts[kernel] >= 1, f"{spec}: no {kernel} kernel launch")
        need(y.shape == (spec.R, W), y.shape)
        need(np.array_equal(oracle_parity(system.encode_plan.A, x[:, :cols]),
                            y[:, :cols]), f"{spec}: parity differs from x^T A")
        for name, n in counts.items():
            total[name] += n
    return total


# ---------------------------------------------------------------------------
# mesh phase: gf_matmul's batched entry, then the mesh backend
# ---------------------------------------------------------------------------

def batched_kernel_phase(gen) -> dict:
    """`gf_matmul_batched`'s two designs, each forced, bitwise against the
    plain version at edge shapes and at the sweep's shapes; each design
    timed at every sweep shape beside its bound, the plain version and the
    `bmm` yardstick; the dispatch's choice beside the faster design.
    Returns the summary entry of the design the main path runs ("small",
    at the mesh combine's shape)."""
    import ctypes

    import torch

    from repro_torch.kernels import build, gf_matmul_batched, gf_matmul_batched_plain
    from repro_torch.kernels.gf_matmul import (_SMALL_CROSSOVER, _SMALL_MAX_K,
                                               _SMALL_MAX_M, _batched_design)

    dev = torch.device("cuda")
    worst = dict.fromkeys(BATCHED_DESIGNS, 0)
    config = build.entry("gf_matmul_small", "gf_matmul_small_config",
                         [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                         + [ctypes.POINTER(ctypes.c_int)])

    def rnd(*shape):
        return torch.randint(0, Q, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def takes(design, M, K):
        return design == "imma" or (M <= _SMALL_MAX_M and K <= _SMALL_MAX_K)

    def check(name, a, b, want=None):
        """Both designs (where they take the shape) against the plain
        version."""
        B, M, K = a.shape
        if want is None:
            want = gf_matmul_batched_plain(a, b)
        for design in BATCHED_DESIGNS:
            if not takes(design, M, K):
                continue
            before = gf_matmul_batched.launches_by_design[design]
            got = gf_matmul_batched(a, b, _design=design)
            torch.cuda.synchronize()
            need(gf_matmul_batched.launches_by_design[design] == before + 1,
                 f"{name}: the {design} design did not launch")
            err = max_abs_err(got, want)
            worst[design] = max(worst[design], err)
            print(json.dumps({"check": f"gf_matmul_batched {name}",
                              "design": BATCHED_DESIGNS[design],
                              "shape": list(got.shape), "max_abs_err": err,
                              "tolerance": 0}))
            need(err == 0, f"gf_matmul_batched {name} ({design}): results "
                 f"differ ({err})")

    # -- edge shapes: B = M = K = 1 with a = 65536; per-batch 65536 flags; M
    # past one 32-row tile and K past one chunk (imma only); N % 4 in
    # {1, 2, 3} with a ragged last tile; all-65536 operands; K = 0; a base
    # of b that is not 16-byte aligned (the small design's scalar path) --
    a = torch.full((1, 1, 1), Q - 1, device=dev, dtype=torch.int32)
    check("edge B=1 M=1 K=1 N=129, a = 65536", a, rnd(1, 1, 129))
    a, b = rnd(3, 33, 300), rnd(3, 300, 1000)
    a[1, 32, 7] = Q - 1
    b[2, 299, 999] = Q - 1
    check("edge (3; 33x300 . 300x1000), one 65536 in one batch", a, b)
    check("edge (5; 9x8 . 8x7)", rnd(5, 9, 8), rnd(5, 8, 7))
    for N in (4097, 4098, 4099):
        check(f"edge (7; 9x8 . 8x{N}), N % 4 = {N % 4}", rnd(7, 9, 8),
              rnd(7, 8, N))
    check("edge M=K=1 (3; 1x1 . 1x5000)", rnd(3, 1, 1), rnd(3, 1, 5000))
    check("edge K=0 (2; 4x0 . 0x100)", rnd(2, 4, 0), rnd(2, 0, 100))
    check("edge (2; 64x32 . 32x1000), the small design's largest a",
          rnd(2, 64, 32), rnd(2, 32, 1000))
    for B, M, K, N in [(4, 33, 32, 1000), (7, 9, 8, 4096), (2, 64, 256, 4096)]:
        full = torch.full((B, M, K), Q - 1, device=dev, dtype=torch.int32)
        fb = torch.full((B, K, N), Q - 1, device=dev, dtype=torch.int32)
        check(f"all-65536 ({B}; {M}x{K} . {K}x{N})", full, fb)
    flat = rnd(3 * 8 * 4096 + 1)
    check("unaligned base of b (3; 9x8 . 8x4096)", rnd(3, 9, 8),
          flat[1:].view(3, 8, 4096))

    # -- the sweep: the mesh's combine shapes at N = 2^18, two deeper ones
    # with b about 2 GB; each design timed, checked first --------------------
    sweep = []
    for B, M, K, N, main in BATCHED_SWEEP:
        name = f"({B}; {M}x{K} . {K}x{N})"
        a, b = rnd(B, M, K), rnd(B, K, N)
        want = gf_matmul_batched_plain(a, b)
        check(f"sweep {name}", a, b, want)

        def library(a=a, b=b):  # exact: K products < 2^37 < 2^53
            return torch.remainder(torch.bmm(a.double(), b.double()), Q)

        lib_err = max_abs_err(library().long(), want)
        need(lib_err == 0, f"bmm yardstick {name} differs ({lib_err})")
        del want
        info = (ctypes.c_int * 8)()  # c's alignment: a fresh output's, as b's
        build.check(config(b.data_ptr(), b.data_ptr(), B, M, N, K, info),
                    "gf_matmul_small_config")
        nbytes = 4 * (B * M * K + B * K * N + B * M * N)
        reps = 20
        row = {"shape": name, "main_path_shape": main, "bytes": nbytes,
               "dispatch": _batched_design(M, K),
               "plain_ms": time_ms(lambda: gf_matmul_batched_plain(a, b), 3),
               "library_ms": time_ms(library, 5), "designs": {},
               "small_config": dict(zip(
                   ("tile_columns", "row_chunks", "rows_a_chunk", "smem_bytes",
                    "blocks_per_sm", "grid", "vec16", "sms"), info))}
        for design in ("small", "imma", "imma", "small"):  # in turns
            if takes(design, M, K):
                row["designs"].setdefault(design, []).append(time_ms(
                    lambda d=design: gf_matmul_batched(a, b, _design=d), reps))
        for design in list(row["designs"]):
            if design == "small":  # 64-bit multiply-adds on the INT32 lanes
                ops, rate = B * M * K * N, INT32_MAD_PER_S
            else:  # u8 limb products on the tensor cores
                ops = sum(imma_macs(a[z], b[z]) for z in range(B))
                rate = INT8_MAC_PER_S
            b_ms, b_by = bound(nbytes, ops, rate)
            ms = row["designs"][design]
            mean = sum(ms) / len(ms)
            row["designs"][design] = {
                "design": BATCHED_DESIGNS[design], "kernel_ms": ms,
                "mean_ms": mean, "ops": ops, "bound_ms": b_ms,
                "bound_by": b_by, "bound_share": b_ms / mean}
        row["faster"] = min(row["designs"],
                            key=lambda d: row["designs"][d]["mean_ms"])
        row["dispatch_takes_faster"] = row["faster"] == row["dispatch"]
        print(json.dumps({"kernel": "gf_matmul_batched", **row}))
        sweep.append(row)
        del a, b, library
    print(json.dumps({"batched_dispatch": {
        "rule": f"small while M <= {_SMALL_MAX_M}, K <= {_SMALL_MAX_K} and "
                f"M K <= {_SMALL_CROSSOVER} (M + K), else imma",
        "crossover": _SMALL_CROSSOVER,
        "picks": {r["shape"]: r["dispatch"] for r in sweep},
        "faster": {r["shape"]: r["faster"] for r in sweep}}}))
    torch.cuda.empty_cache()

    main = next(r for r in sweep if r["main_path_shape"])
    need(main["dispatch"] == "small", "the mesh combine's shape does not "
         "take the small design")
    small = main["designs"]["small"]
    return {"shapes": [f"mesh combine {main['shape']}"], "ms": small["mean_ms"],
            "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
            "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
            "max_abs_err": worst["small"],
            "designs": {d: {"ms": v["mean_ms"],
                            "bound_share": v["bound_share"],
                            "max_abs_err": worst[d]}
                        for d, v in main["designs"].items()}}


class PlainCalls:
    """Counts calls of the kernels' plain versions made by the wrappers
    (`kernels.gf_matmul` and `kernels.ntt` call them only for CPU tensors):
    a path on the card must make none."""

    NAMES = (("repro_torch.kernels.gf_matmul", "gf_matmul_plain"),
             ("repro_torch.kernels.gf_matmul", "gf_matmul_batched_plain"),
             ("repro_torch.kernels.ntt", "ntt_plain"))

    def __enter__(self):
        import importlib

        self.n = 0
        self.saved = []
        for mod_name, name in self.NAMES:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            self.saved.append((mod, name, fn))

            def counted(*args, _fn=fn, **kwargs):
                self.n += 1
                return _fn(*args, **kwargs)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def mesh_phase() -> dict:
    """The mesh backend on the card (G = 1: every processor in one tensor):
    the main path's chain at rs 256/64, W=2^18, 64 seeded erasures, each
    op against the local backend's output; a forced method="rs" encode, a
    dft 4096 encode and a commuted (`build_ir_mesh_program`) rs 256/64
    encode.  Every op with the launch counts set to 0 just before and read
    just after.  Returns each kernel's launches summed."""
    import torch

    from repro_torch.api import CodedSystem, CodeSpec, Topology
    from repro_torch.core.shardmap_exec import build_ir_mesh_program
    from repro_torch.recover.backends import _mesh_callables

    rng = np.random.default_rng(SEED + 16)
    spec = CodeSpec(kind="rs", K=256, R=64)
    W = MAIN_W
    x = rng.integers(0, Q, (spec.K, W), dtype=np.int64)
    dead = seeded_erasures(rng, spec.K, spec.R)
    total = dict.fromkeys(DESIGNS, 0)

    local = CodedSystem(spec, backend="local")  # the references, uncounted
    ref_cw = local.codeword(x)
    lost = ref_cw.copy()
    lost[dead] = 0
    local.close()

    def op(system, name, fn, want, expect):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with PlainCalls() as plain:
            out = timed_op(system, name, fn)
        torch.cuda.synchronize()
        counts = read_counts()
        for k, n in counts.items():
            total[k] += n
        ok = np.array_equal(out, want)
        print(json.dumps({
            "mesh_op": name, "spec": f"{system.spec.kind} K={system.spec.K} "
            f"R={system.spec.R}", "method": system.encode_plan.method,
            "launches": counts, "plain_calls": plain.n, "equal_local": ok,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mesh": system.encode_plan.describe().splitlines()[-1].strip()}))
        need(ok, f"mesh {name} differs from the local backend")
        need(plain.n == 0, f"mesh {name}: a plain version ran on the card")
        for k, n in expect.items():
            need(counts[k] == n, f"mesh {name}: {k} launched {counts[k]} "
                 f"times, expected {n}")
        return out

    def built(system, what: str):
        """Build the session's mesh programs (plan-time work: tables, their
        rows on the card) before the timed op, and print how long it took."""
        t0 = time.perf_counter()
        if what == "encode":
            system.encode_plan.mesh_callable()
        else:
            _mesh_callables(system.decode_plan)
        torch.cuda.synchronize()
        print(json.dumps({"op": f"build mesh {what} program", "spec":
                          f"{system.spec.kind} K={system.spec.K} "
                          f"R={system.spec.R}", "wall_ms":
                          (time.perf_counter() - t0) * 1e3}))

    t0 = time.perf_counter()
    system = CodedSystem(spec, backend="mesh", trace=True)
    need(system.encode_plan.method == "universal", system.encode_plan.method)
    print(json.dumps({"op": "plan_encode", "backend": "mesh", "wall_ms":
                      (time.perf_counter() - t0) * 1e3}))
    built(system, "encode")
    # one combine launch a universal stage, and it runs the small design
    one_stage = {"gf_matmul_batched": 1, "gf_matmul_batched_imma": 0,
                 "gf_matmul": 0, "ntt": 0}
    cw = op(system, "codeword", lambda: system.codeword(x), ref_cw, one_stage)
    system.fail(dead.tolist())
    built(system, "decode")
    op(system, "read", lambda: system.read(lost), x,
       {"gf_matmul_batched": 0, "gf_matmul_batched_imma": 0, "gf_matmul": 1})
    batches = system.decode_plan.tables.batches()
    op(system, "rebuild", lambda: system.rebuild(lost), cw,
       dict(one_stage, gf_matmul_batched=len(batches)))
    system.heal()
    need(system.failed == (), system.failed)
    print(json.dumps({"mesh_path": f"rs K=256 R=64 W={W}", "erased":
                      len(dead), "codeword_read_rebuild_equal_local": True,
                      "decode_batches": batches}))
    system.close()

    # the forced Thm. 7 schedule: draw-and-loose, here DFT butterflies
    system = CodedSystem(spec, backend="mesh", method="rs", trace=True)
    built(system, "encode")
    op(system, "encode method=rs", lambda: system.encode(x), ref_cw[spec.K:],
       {"gf_matmul": 0, "ntt": 0})
    system.close()

    # dft K=4096: the paper's butterfly rounds across 4096 processors
    dspec = CodeSpec(kind="dft", K=MESH_DFT_K, R=MESH_DFT_K)
    xd = rng.integers(0, Q, (dspec.K, DFT_W), dtype=np.int64)
    ref = CodedSystem(dspec, backend="local")
    want = ref.encode(xd)
    ref.close()
    system = CodedSystem(dspec, backend="mesh", trace=True)
    built(system, "encode")
    op(system, f"encode dft K={MESH_DFT_K} W={DFT_W}",
       lambda: system.encode(xd), want,
       {"gf_matmul_batched": 0, "gf_matmul_batched_imma": 0, "gf_matmul": 0,
        "ntt": 0})
    system.close()

    # a commute=True plan: the generic IR lowering at rs 256/64
    t0 = time.perf_counter()
    system = CodedSystem(spec, backend="mesh", trace=True, commute=True,
                         topology=Topology(*MESH_COMMUTE_TOPO))
    plan = system.encode_plan
    ir = plan.schedule_ir()
    prog = build_ir_mesh_program(ir, list(range(spec.K)) + list(range(spec.R)))
    build_s = time.perf_counter() - t0
    fired = any(r.tag.startswith("commute") for r in ir.rounds)
    print(json.dumps({"commuted_plan": f"rs K=256 R=64 on Topology"
                      f"{MESH_COMMUTE_TOPO}", "host_build_s": build_s,
                      "rewrite_fired": fired, "rounds": len(prog.rounds),
                      "legs": sum(len(legs) for legs, _ in prog.rounds),
                      "slots": prog.n_slots}))
    need(build_s < 60, f"commuted plan's host build took {build_s:.1f} s")
    need(fired, "the tier_commute rewrite did not fire")
    built(system, "encode")
    op(system, "encode commute=True", lambda: system.encode(x),
       ref_cw[spec.K:], {"gf_matmul": 0, "ntt": 0})
    system.close()
    return total


# ---------------------------------------------------------------------------
# stream phase
# ---------------------------------------------------------------------------

def seeded_erasures(rng, K: int, R: int):
    """40 data and 24 parity positions of rs 256/64 (R of them in all)."""
    return np.sort(np.concatenate([rng.choice(K, 40, replace=False),
                                   K + rng.choice(R, R - 40, replace=False)]))


def stream_phase():
    """The session's streaming surface on the card; returns each kernel's
    launches summed over the phase's ops (each counted from 0 just before
    it to just after it)."""
    from repro_torch.api import CodedSystem, CodeSpec, stream

    rng = np.random.default_rng(SEED + 1)
    spec = CodeSpec(kind="rs", K=256, R=64)
    K, W = spec.K, MAIN_W
    x = rng.integers(0, Q, (K, W), dtype=np.int64)
    dead = seeded_erasures(rng, K, spec.R)
    system = CodedSystem(spec, backend="local")
    default_w = stream.plan_chunk_w(system.encode_plan)
    total = dict.fromkeys(DESIGNS, 0)
    overlaps = []

    def cat(blocks):
        return np.concatenate(list(blocks), axis=1)

    def run(name, fn, chunk_w, per_chunk=(), quiet=False):
        """One op, counts reset before and read after, on a CUDA-event
        timeline; checks >= 1 launch per chunk of each kernel named."""
        reset_counts()
        with stream.record_timeline() as tl:
            t0 = time.perf_counter()
            out = fn()
            wall = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        chunks = sum(len(r) for r in tl.runs)
        overlap = tl.overlap_ms() if chunks else 0.0
        busy = tl.busy_ms() if chunks else None
        overlaps.append(overlap)
        line = {"op": name, "spec": "rs K=256 R=64", "W": W,
                "wall_ms": wall, "chunk_w": chunk_w, "chunks": chunks,
                "gb_per_s": 4 * K * W / wall / 1e6, "overlap_ms": overlap,
                "device_busy_ms": busy, "launches": counts, "card": CARD}
        if not quiet:
            print(json.dumps(line))
        for kernel in per_chunk:
            need(counts[kernel] >= max(1, chunks),
                 f"{name}: {counts[kernel]} {kernel} launches for {chunks} "
                 "chunks")
        for k, n in counts.items():
            total[k] += n
        return out, line

    parity, _ = run("encode (direct)", lambda: system.encode(x), None)
    got, _ = run("encode_stream", lambda: cat(system.encode_stream(x)),
                 default_w, ("ntt",))
    need(np.array_equal(got, parity), "encode_stream differs from encode")
    cw = np.concatenate([x, parity])
    lost = cw.copy()
    lost[dead] = 0
    system.fail(dead.tolist())
    rep_direct, _ = run("decode (direct)", lambda: system.decode(lost), None)
    got, _ = run("decode_stream", lambda: cat(system.decode_stream(lost)),
                 default_w, ("gf_matmul",))
    need(np.array_equal(got, rep_direct), "decode_stream differs from decode")
    need(np.array_equal(got, cw[dead]), "decode_stream differs from the codeword")
    got, _ = run("rebuild_stream", lambda: cat(system.rebuild_stream(lost)),
                 default_w, ("gf_matmul",))
    need(np.array_equal(got, cw), "rebuild_stream differs from the codeword")
    need(system.failed == (), f"rebuild_stream left {system.failed} failed")
    bounds = np.cumsum([0] + BATCH_W + [W - sum(BATCH_W)])
    xs = [x[:, a:b] for a, b in zip(bounds, bounds[1:])]
    outs, _ = run("encode_batched", lambda: system.encode_batched(xs),
                  default_w, ("ntt",))
    for xi, yi in zip(xs, outs):
        need(np.array_equal(yi, system.encode(xi)),
             f"encode_batched differs at width {xi.shape[1]}")

    # a burst of queued futures: 16 encodes, then 8 decodes of a failure
    cols = 4096
    system.fail(dead.tolist())
    enc_in = [x[:, i * cols:(i + 1) * cols] for i in range(16)]
    dec_in = [lost[:, i * cols:(i + 1) * cols] for i in range(8)]
    reset_counts()
    t0 = time.perf_counter()
    futs = ([system.submit("encode", p) for p in enc_in]
            + [system.submit("decode", p) for p in dec_in])
    results = [f.result(timeout=600) for f in futs]
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    qstats = system.stats()["queue"]
    for p, r in zip(enc_in, results[:16]):
        need(np.array_equal(r, system.encode(p)), "queued encode differs")
    for p, r in zip(dec_in, results[16:]):
        need(np.array_equal(r, system.decode(p)), "queued decode differs")
    need(qstats.max_coalesced > 1, f"queue did not coalesce: {qstats}")
    need(counts["gf_matmul"] >= 1 and counts["ntt"] >= 1, counts)
    for k, n in counts.items():
        total[k] += n
    print(json.dumps({"op": "submit burst", "requests": len(futs),
                      "payload": f"16 encodes (256, {cols}) + 8 decodes "
                      f"(320, {cols})", "wall_ms": wall,
                      "batches": qstats.batches,
                      "coalesced": qstats.coalesced,
                      "max_coalesced": qstats.max_coalesced,
                      "launches": counts, "card": CARD}))
    system.close()

    # chunk-width sweep: three passes over the widths (up, down, up),
    # failure set held
    sweep = {"encode_stream": [], "decode_stream": []}
    for pass_ in range(3):
        for w in (SWEEP_W[::-1] if pass_ == 1 else SWEEP_W):
            got, line = run("encode_stream", lambda w=w: cat(
                system.encode_stream(x, chunk_w=w)), w, ("ntt",), quiet=True)
            need(np.array_equal(got, parity), f"encode_stream chunk_w={w}")
            sweep["encode_stream"].append(line)
            got, line = run("decode_stream", lambda w=w: cat(
                system.decode_stream(lost, chunk_w=w)), w, ("gf_matmul",),
                quiet=True)
            need(np.array_equal(got, rep_direct), f"decode_stream chunk_w={w}")
            sweep["decode_stream"].append(line)
    mean_wall = dict.fromkeys(SWEEP_W, 0.0)   # both ops, mean over passes
    for op, lines in sweep.items():
        by_w = {}
        for ln in lines:
            by_w.setdefault(ln["chunk_w"], []).append(ln)
        rows = []
        for w, ls in sorted(by_w.items()):
            walls = [ln["wall_ms"] for ln in ls]
            mean_wall[w] += sum(walls) / len(walls)
            rows.append({"chunk_w": w, "budget_bytes": 4 * K * w,
                         "chunks": ls[0]["chunks"], "wall_ms": walls,
                         "mean_gb_per_s": 4 * K * W * len(walls)
                         / sum(walls) / 1e6,
                         "overlap_ms": [ln["overlap_ms"] for ln in ls],
                         "device_busy_ms": [ln["device_busy_ms"] for ln in ls]})
        print(json.dumps({"sweep": op, "spec": "rs K=256 R=64", "W": W,
                          "rows": rows, "card": CARD}))
    best = min(mean_wall, key=mean_wall.get)
    print(json.dumps({"sweep_best": {"chunk_w": best, "budget_bytes": 4 * K * best,
                                     "encode_plus_decode_mean_wall_ms":
                                     mean_wall[best]},
                      "default_chunk_w": default_w, "card": CARD}))
    print(json.dumps({"overlap": {"max_ms": max(overlaps),
                                  "ops_with_overlap": sum(o > 0 for o in overlaps),
                                  "ops": len(overlaps)}, "card": CARD}))
    need(max(overlaps) > 0, "no op overlapped a chunk's copy with kernels")
    system.heal()
    return total


# ---------------------------------------------------------------------------
# simulator phase (host only)
# ---------------------------------------------------------------------------

def simulator_phase() -> None:
    """The round-network simulator at the README's size against the card's
    local values; measured C1/C2 against the plans' costs, zero drift."""
    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.obs.drift import LEDGER

    LEDGER.reset()
    rng = np.random.default_rng(SEED + 2)
    for spec, dead in [(CodeSpec(kind="rs", K=16, R=4), [2, 17]),
                       (CodeSpec(kind="universal", K=16, R=4, seed=0), [0, 19]),
                       (CodeSpec(kind="lagrange", K=16, R=4), [5, 16]),
                       (CodeSpec(kind="dft", K=16, R=16), [5, 9, 13])]:
        sim = CodedSystem(spec, backend="simulator")
        card = CodedSystem(spec, backend="local")
        need(sim.device is None and card.device.type == "cuda",
             (sim.device, card.device))
        x = rng.integers(0, Q, (spec.K, SIM_W), dtype=np.int64)
        t0 = time.perf_counter()
        cw = sim.codeword(x)
        enc_ms = (time.perf_counter() - t0) * 1e3
        need(np.array_equal(cw, card.codeword(x)), f"{spec}: simulator parity")
        plan = sim.encode_plan
        c, last = plan.cost(), plan.last_stats
        need((last.C1, last.C2) == (c.C1, c.C2 * SIM_W),
             f"{spec}: encode measured {last} vs cost {c}")
        blocks = list(sim.encode_stream(x, chunk_w=SIM_W // 4))
        need(np.array_equal(np.concatenate(blocks, 1), cw[spec.K:]),
             f"{spec}: simulator stream")
        st = plan.stream_stats
        need(st.C1 == [c.C1] * 4 and st.C2 == [c.C2 * SIM_W // 4] * 4,
             f"{spec}: per-chunk stream stats {st}")
        for s in (sim, card):
            s.fail(dead)
        lost = cw.copy()
        lost[dead] = 0
        t0 = time.perf_counter()
        rep = sim.decode(lost)
        dec_ms = (time.perf_counter() - t0) * 1e3
        need(np.array_equal(rep, card.decode(lost)), f"{spec}: simulator decode")
        need(np.array_equal(rep, cw[dead]), f"{spec}: decode vs codeword")
        dplan = sim.decode_plan
        dc, dlast = dplan.cost(), dplan.last_stats
        need((dlast.C1, dlast.C2) == (dc.C1, dc.C2 * SIM_W),
             f"{spec}: decode measured {dlast} vs cost {dc}")
        print(json.dumps({
            "simulator": f"{spec.kind} K={spec.K} R={spec.R}", "W": SIM_W,
            "method": plan.method, "erased": dead,
            "encode": {"C1": last.C1, "C2": last.C2, "wall_ms": enc_ms},
            "decode": {"C1": dlast.C1, "C2": dlast.C2, "wall_ms": dec_ms},
            "equal_to_local": True, "cost_exact": True}))
        print(sim.describe())
        print(json.dumps({"stats_keys": sorted(sim.stats()),
                          "encode_keys": sorted(sim.stats()["encode"])}))
        sim.close()
        card.close()
    drifted = LEDGER.drifted()
    need(drifted == [], f"drift ledger: {drifted}")
    print(json.dumps({"drift": "zero", "runs": sum(
        e.runs for e in LEDGER.entries())}))


# ---------------------------------------------------------------------------
# solve phase
# ---------------------------------------------------------------------------

def counted(name: str, fn, total: dict):
    """Run `fn` with the launch counts set to 0 just before and read just
    after; add them to `total`.  Returns (result, wall ms, counts)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    for k, n in counts.items():
        total[k] += n
    return out, wall, counts


def solve_phase():
    """`reconstruct` (the Gauss-Jordan inverse on the card, then
    `gf_matmul`) at the main path's size; returns each kernel's launches."""
    import torch

    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.core.field import FERMAT
    from repro_torch.core.matrices import gauss_inverse
    from repro_torch.core.parity import reconstruct
    from repro_torch.kernels import gf_gauss_inverse

    total = dict.fromkeys(DESIGNS, 0)
    rng = np.random.default_rng(SEED + 3)
    spec = CodeSpec(kind="rs", K=256, R=64)
    x = rng.integers(0, Q, (spec.K, SOLVE_W), dtype=np.int64)
    dead = seeded_erasures(rng, spec.K, spec.R)
    system = CodedSystem(spec, backend="local")
    sgrs = system.encode_plan.sgrs
    cw = system.codeword(x)
    system.close()
    kept = np.array([i for i in range(spec.N) if i not in set(dead.tolist())])
    need(kept.size == spec.K, kept.size)
    vals = cw[kept]
    got, wall, counts = counted(
        "reconstruct", lambda: reconstruct(FERMAT, sgrs, kept, vals), total)
    need(np.array_equal(got, x), "reconstruct differs from the data")
    need(counts["gf_matmul"] >= 1, f"reconstruct launched no gf_matmul: {counts}")
    G = np.concatenate([np.eye(spec.K, dtype=np.int64), sgrs.grs.A_direct()], 1)
    sub_t = G[:, kept].T % Q
    gf_gauss_inverse(np.eye(2, dtype=np.int64))  # its inverse table, once
    inv, inv_ms, _ = counted("inverse", lambda: gf_gauss_inverse(sub_t), total)
    t0 = time.perf_counter()
    host = gauss_inverse(FERMAT, sub_t)
    host_ms = (time.perf_counter() - t0) * 1e3
    need(inv.device.type == "cuda", inv.device)
    need(np.array_equal(inv.cpu().numpy(), host),
         "card inverse differs from the host's gauss_inverse")
    print(json.dumps({
        "solve": f"reconstruct rs K=256 R=64 W={SOLVE_W}", "erased": len(dead),
        "wall_ms": wall, "launches": counts, "exact": True,
        "gauss_inverse_256": {"card_ms": inv_ms, "host_ms": host_ms,
                              "equal": True},
        "card": CARD}))
    del inv
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# checkpoint phase
# ---------------------------------------------------------------------------

def qwen3_layers_state(n_layers: int, gen):
    """A seeded OrderedDict state with the shapes of the first `n_layers`
    decoder layers of Qwen3-1.7B (src/repro/configs/qwen3_1_7b.py: d_model
    2048, 16 heads x 128, 8 KV heads, d_ff 6144, q/k norms), bf16 on the
    card, in the Hugging Face layout, plus an int64 step leaf."""
    from collections import OrderedDict

    import torch

    D, H, KV, hd, F = 2048, 16, 8, 128, 6144
    shapes = [("input_layernorm.weight", (D,)),
              ("self_attn.q_proj.weight", (H * hd, D)),
              ("self_attn.k_proj.weight", (KV * hd, D)),
              ("self_attn.v_proj.weight", (KV * hd, D)),
              ("self_attn.o_proj.weight", (D, H * hd)),
              ("self_attn.q_norm.weight", (hd,)),
              ("self_attn.k_norm.weight", (hd,)),
              ("post_attention_layernorm.weight", (D,)),
              ("mlp.gate_proj.weight", (F, D)),
              ("mlp.up_proj.weight", (F, D)),
              ("mlp.down_proj.weight", (D, F))]
    state = OrderedDict()
    for i in range(n_layers):
        for name, shape in shapes:
            state[f"model.layers.{i}.{name}"] = (torch.randn(
                shape, generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
    state["step"] = torch.tensor(1000, dtype=torch.int64)
    return state


def leaf_bytes(tree) -> list[bytes]:
    """Each leaf's raw bytes in order (bf16 by its bits), on the host."""
    import torch

    out = []
    for v in tree.values():
        t = v.detach().cpu()
        out.append((t.view(torch.int16) if t.dtype == torch.bfloat16
                    else t).numpy().tobytes())
    return out


def checkpoint_phase(gen):
    """The coded-checkpoint deployment on the card; returns each kernel's
    launches summed over its operations."""
    import hashlib
    import shutil
    import tempfile
    from pathlib import Path

    from repro_torch.api import stream
    from repro_torch.ckpt import CodedCheckpointer
    from repro_torch.obs import trace

    total = dict.fromkeys(DESIGNS, 0)
    state = qwen3_layers_state(CKPT_LAYERS, gen)
    want = leaf_bytes(state)
    nbytes = sum(len(b) for b in want)
    params = sum(v.numel() for k, v in state.items() if k != "step")
    root = tempfile.mkdtemp(prefix="coded_ckpt_")
    try:
        ck = CodedCheckpointer(root, n_shards=16, n_parity=4)
        need(ck._system.device.type == "cuda", ck._system.device)
        need(ck._system.encode_plan.local_impl == "ntt",
             ck._system.encode_plan.local_impl)
        chunk_w = stream.plan_chunk_w(ck._system.encode_plan)
        L = -(-(-(-nbytes // 2)) // 16)
        chunks = -(-L // chunk_w)
        example = type(state)((k, v.cpu()) for k, v in state.items())
        print(json.dumps({
            "checkpoint": "Qwen3-1.7B decoder layers, bf16, N=16 R=4",
            "layers": CKPT_LAYERS, "reduced": f"{CKPT_LAYERS} of 28 layers "
            "(the chip run's time)", "params": params, "state_bytes": nbytes,
            "shard_symbols": L, "chunk_w": chunk_w, "chunks": chunks,
            "card": CARD}))

        def op(name, fn, kernel=None):
            """One checkpoint op; the card's busy time from the pipeline's
            CUDA events (recorded on this thread only: not for the
            background save's worker), and the host time of each of the
            checkpointer's stages and the stream's per-chunk stages, summed
            from their spans on the installed tracer."""
            with stream.record_timeline() as tl, trace.installed() as tr:
                out, wall, counts = counted(name, fn, total)
            busy = tl.busy_ms() if tl.runs else None
            stages: dict = {}
            for e in tr.events():
                key = f"{e.get('cat', '')}.{e['name']}"
                stages[key] = stages.get(key, 0.0) + e["dur"] / 1e3
            print(json.dumps({"op": name, "wall_ms": wall,
                              "gb_per_s": nbytes / wall / 1e6,
                              "chunk_w": chunk_w, "chunks": chunks,
                              "device_busy_ms": busy,
                              "device_idle_share": (None if busy is None
                                                    else 1 - busy / wall),
                              "stages_ms": stages,
                              "launches": counts, "card": CARD}))
            if kernel is not None:
                need(counts[kernel] >= chunks,
                     f"{name}: {counts[kernel]} {kernel} launches for "
                     f"{chunks} chunks")
            return out

        def restored(name, step, **kw):
            got = op(name, lambda: ck.restore(step, example, **kw),
                     "gf_matmul" if kw else None)
            need(leaf_bytes(got) == want, f"{name}: restore differs")

        op("save step 1", lambda: ck.save(1, state), "ntt")

        def background():
            ck.save(2, state, background=True)
            ck.wait()
        op("save step 2 (background) + wait", background, "ntt")
        restored("restore step 2", 2)
        restored("restore step 2, shards 2 5 11 14 failed", 2,
                 failed_shards=set(CKPT_KILLS))
        d = Path(root) / "step_000001"
        (d / "shard_002.npy").unlink()
        for name in ("shard_005.npy", "parity_001.npy"):
            arr = np.load(d / name)
            arr[7] = (arr[7] + 1) % Q
            np.save(d / name, arr)
        rep = op("scrub step 1 (1 missing, 2 corrupt)", lambda: ck.scrub(1),
                 "gf_matmul")
        print(json.dumps({"scrub_report": rep}))
        need(rep["missing"] == [2] and rep["corrupt"] == [5, 17]
             and rep["rebuilt"] == [2, 5, 17] and rep["verified"], rep)
        rep = op("scrub step 1 again", lambda: ck.scrub(1))
        need(rep["rebuilt"] == [], rep)
        restored("restore step 1 after scrub", 1)
        for step in (1, 2):
            sd = Path(root) / f"step_{step:06d}"
            sums = json.loads((sd / "meta.json").read_text())["sha256"]
            need(len(sums) == 20, len(sums))
            for fname, digest in sums.items():
                got = hashlib.sha256(np.load(sd / f"{fname}.npy").tobytes())
                need(got.hexdigest() == digest, f"step {step} {fname}: sha256")
        print(json.dumps({"checkpoint_checks": "every restore equal to the "
                          "state byte for byte; 40 files' sha256 equal to "
                          "save's", "ok": True}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# coding phase
# ---------------------------------------------------------------------------

def coding_phase(gen):
    """Coded matmul, Lagrange coded computing and gradient coding on the
    card; returns each kernel's launches."""
    import itertools

    import torch

    from repro_torch.coding import CodedMatmul, GradientCoder, LagrangeComputer
    from repro_torch.core.field import FERMAT

    total = dict.fromkeys(DESIGNS, 0)
    rng = np.random.default_rng(SEED + 4)
    K, R, d, out = 16, 4, 2048, 256
    X = FERMAT.rand((K * CM_ROWS, d), rng)
    Wm = FERMAT.rand((d, out), rng)
    truth = FERMAT.matmul(X, Wm)
    with CodedMatmul(K, R) as cm:
        need(cm.system.encode_plan.local_impl == "ntt",
             cm.system.encode_plan.local_impl)
        shards, enc_ms, counts = counted("encode", lambda: cm.encode(X), total)
        need(counts["ntt"] >= 1, f"CodedMatmul.encode: {counts}")
        results = cm.worker_compute(shards, Wm)  # the workers (host numpy)
        lines = [{"encode_ms": enc_ms, "launches": counts}]
        for n_dead in range(R + 1):
            dead = np.sort(rng.choice(K + R, n_dead, replace=False))
            got, ms, counts = counted("decode",
                                      lambda: cm.decode(results, dead), total)
            need(np.array_equal(got, truth), f"CodedMatmul dead={dead}")
            need(n_dead == 0 or counts["gf_matmul"] >= 1, counts)
            need(not cm.system.failed, cm.system.failed)
            lines.append({"dead": dead.tolist(), "decode_ms": ms,
                          "launches": counts})
    print(json.dumps({"coded_matmul": f"K={K} R={R} X ({K * CM_ROWS}, {d}) "
                      f"W ({d}, {out})", "runs": lines, "exact": True,
                      "card": CARD}))

    lcc_lines = []
    for deg, N in ((1, 20), (2, 36)):
        lcc = LagrangeComputer.build(FERMAT, K, N)
        x = FERMAT.rand((K, LCC_W), rng)
        coded, enc_ms, enc_counts = counted("encode", lambda: lcc.encode(x),
                                            total)
        need(enc_counts["gf_matmul"] + enc_counts["ntt"] >= 1, enc_counts)

        def poly(v):
            y = v
            for _ in range(deg - 1):
                y = FERMAT.mul(y, v)
            return FERMAT.add(y, 7)

        results, truth_l = poly(coded), poly(x)
        T = lcc.recovery_threshold(deg)
        for trial in range(3):
            ids = rng.permutation(N)[: int(rng.integers(T, N + 1))]
            got, ms, counts = counted(
                "decode", lambda: lcc.decode(deg, ids, results[ids]), total)
            need(np.array_equal(got, truth_l), f"LCC deg={deg} ids={ids}")
            need(counts["gf_matmul"] >= 1, f"LCC decode: {counts}")
            lcc_lines.append({"deg": deg, "N": N, "workers": int(ids.size),
                              "threshold": T, "encode_ms": enc_ms,
                              "decode_ms": ms, "launches": counts})
    print(json.dumps({"lagrange": f"K={K} W={LCC_W}", "runs": lcc_lines,
                      "exact": True, "card": CARD}))

    # gradient coding: 16 workers in 4 groups of 4, every member of a group
    # reporting the group's sum; one straggler per group in every pattern
    gc = GradientCoder(16, 3)
    shapes = [(2048,), (2048, 2048), (1024, 2048), (1024, 2048), (2048, 2048),
              (128,), (128,), (2048,), (6144, 2048), (6144, 2048), (2048, 6144)]
    group_sums = [[torch.randn(s, generator=gen, device="cuda")
                   for s in shapes] for _ in range(gc.n_groups)]
    reports = [[t.clone() for t in group_sums[w // 4]] for w in range(16)]
    expect = [(group_sums[0][i] + group_sums[1][i] + group_sums[2][i]
               + group_sums[3][i]) / 16 for i in range(len(shapes))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    patterns = 0
    for stragglers in itertools.product(range(4), repeat=4):
        alive = np.ones(16, bool)
        alive[[4 * g + m for g, m in enumerate(stragglers)]] = False
        got = gc.combine(reports, alive)
        need(all(torch.equal(a, b) for a, b in zip(got, expect)),
             f"combine differs under stragglers {stragglers}")
        patterns += 1
    torch.cuda.synchronize()
    comb_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"gradient_coding": "n=16 s=3, float32 trees of one "
                      "Qwen3-1.7B decoder layer on the card",
                      "patterns": patterns, "bitwise": True,
                      "wall_ms": comb_ms, "ms_per_combine": comb_ms / patterns,
                      "card": CARD}))
    del reports, group_sums, expect
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# service phase
# ---------------------------------------------------------------------------

def service_phase():
    """`CodedService` on the card at rs K=256 R=64; returns each kernel's
    launches summed over its two legs."""
    import threading

    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.core.field import FERMAT
    from repro_torch.launch import CodedService, TenantQuota
    from repro_torch.launch.tenancy import percentile

    total = dict.fromkeys(DESIGNS, 0)
    spec = CodeSpec(kind="rs", K=256, R=64)
    ref = CodedSystem(spec, backend="local")
    cpu = CodedSystem(spec, backend="local", device="cpu")

    def report(leg, svc, wall, counts, n):
        st = svc.stats()
        s = st["service"]
        lat = svc.latencies_us()
        print(json.dumps({
            "service": leg, "spec": "rs K=256 R=64", "ops": n,
            "wall_ms": wall, "requests": s["requests"],
            "batches": s["batches"], "coalescing_ratio": s["coalescing_ratio"],
            "failovers": s["failovers"],
            "p50_us": percentile(lat, 0.50), "p99_us": percentile(lat, 0.99),
            "tenants": {k: {"p50_us": v["p50_us"], "p99_us": v["p99_us"],
                            "completed": v["completed"], "failed": v["failed"]}
                        for k, v in st["tenants"].items()},
            "launches": counts, "card": CARD}))

    # -- leg 1: two tenants' clients, then a degraded read -----------------
    # every payload and reference codeword is made before the counted
    # window, so its launches and wall are the service's alone
    payloads = {t: [FERMAT.rand((spec.K, SVC_W), r)
                    for _ in range(SVC_REQUESTS)]
                for t, r in (("acme", np.random.default_rng(50)),
                             ("zeta", np.random.default_rng(51)))}
    x_read = FERMAT.rand((spec.K, SVC_W), np.random.default_rng(99))
    cw = ref.codeword(x_read)

    def leg1():
        with CodedService(backend="local") as svc:
            need(svc.device.type == "cuda", svc.device)
            svc.set_quota("acme", TenantQuota(32, weight=2.0))
            futs, lock = [], threading.Lock()

            def client(tenant):
                for x in payloads[tenant]:
                    f = svc.submit(tenant, spec, "encode", x,
                                   tag=f"{tenant}/v0")
                    with lock:
                        futs.append((x, f))

            threads = [threading.Thread(target=client, args=(t,))
                       for t in ("acme", "zeta")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                need(not t.is_alive(), "service client thread hung")
            got = [(x, f.result(timeout=600)) for x, f in futs]
            svc.session("zeta", spec).fail(range(spec.R))
            lost = svc.submit("zeta", spec, "decode", cw).result(timeout=600)
            return svc, got, lost

    (svc, got, lost), wall, counts = counted("service", leg1, total)
    for i, (x, y) in enumerate(got):
        need(np.array_equal(y, ref.encode(x)), "service encode differs")
        if i < 2:
            need(np.array_equal(y, cpu.encode(x)), "service encode vs CPU")
    need(np.array_equal(lost, cw[: spec.R]), "service degraded read differs")
    need(counts["ntt"] >= 1, f"service encodes launched no ntt: {counts}")
    need(counts["gf_matmul"] >= 1,
         f"service degraded read launched no gf_matmul: {counts}")
    report("two tenants, 2 x 32 encodes + 1 degraded read", svc, wall, counts,
           len(got) + 1)

    # -- leg 2: chaos under service load ------------------------------------
    rng = np.random.default_rng(SEED + 5)
    data = []
    for t in range(2):
        xt = FERMAT.rand((spec.K, SVC_W), rng)
        data.append((f"tenant{t}", xt, ref.codeword(xt)))

    def leg2():
        with CodedService(backend="local") as svc:
            tens = [(name, svc.session(name, spec), xt, cwt)
                    for name, xt, cwt in data]
            sfuts = []
            for _ in range(36):
                name, sess, xt, cwt = tens[int(rng.integers(2))]
                roll = rng.random()
                if roll < 0.3 and len(sess.failed) < spec.R:
                    alive = [i for i in range(spec.N) if i not in sess.failed]
                    sess.fail(int(rng.choice(alive)))
                elif roll < 0.6:
                    sfuts.append(("encode", (), cwt,
                                  svc.submit(name, spec, "encode", xt)))
                elif roll < 0.85:
                    sfuts.append(("decode", sess.failed, cwt,
                                  svc.submit(name, spec, "decode", cwt)))
                else:
                    sfuts.append(("rebuild", sess.failed, cwt,
                                  svc.submit(name, spec, "rebuild", cwt)))
            res = [(op, pinned, cwt, f.result(timeout=600))
                   for op, pinned, cwt, f in sfuts]
            return svc, res

    (svc, res), wall, counts = counted("chaos", leg2, total)
    for op, pinned, cwt, y in res:
        want = (cwt[spec.K:] if op == "encode"
                else cwt[list(pinned)] if op == "decode" else cwt)
        need(np.array_equal(y, want), f"chaos {op} differs")
    st = svc.stats()
    done = sum(t["completed"] for t in st["tenants"].values())
    need(done == len(res) == st["service"]["requests"],
         f"silent drop: {done} completed of {len(res)}")
    # the service's own launches: ntt for its encodes, gf_matmul for its
    # decodes and rebuilds around failed positions
    need(not any(op == "encode" for op, *_ in res) or counts["ntt"] >= 1,
         f"chaos encodes launched no ntt: {counts}")
    need(not any(op != "encode" and pinned for op, pinned, *_ in res)
         or counts["gf_matmul"] >= 1,
         f"chaos repairs launched no gf_matmul: {counts}")
    report(f"chaos: random fails racing {len(res)} queued ops of 2 tenants",
           svc, wall, counts, len(res))
    ref.close()
    return total


# ---------------------------------------------------------------------------
# serve phase: Qwen3-1.7B at full width behind its coded self-check
# ---------------------------------------------------------------------------

class RssPeak:
    """The process's peak resident set (bytes) over a with-block, sampled
    every `period` s from /proc/self/statm by a thread (the kernel's own
    peak, ru_maxrss, covers the process's whole life)."""

    def __init__(self, period: float = 0.02):
        self.period = period
        self.peak = 0
        self._stop = None
        self._thread = None

    def _rss(self) -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _sample(self) -> None:
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        import threading

        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())


def tree_leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def decode_vs_forward(cfg, model, gen, B: int = 2, S: int = 8) -> float:
    """Stepwise decode logits against one full forward on the card (the
    JAX package's `test_decode_matches_forward`); returns max |diff| and
    fails past atol 0.15 / rtol 0.05."""
    import torch

    from repro_torch.models import model as M

    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    fwd = {"tokens": toks}
    enc = None
    if cfg.family == "encdec":
        frames = torch.randn((B, cfg.n_frames, cfg.d_model), generator=gen,
                             device="cuda")
        enc = M.encode_frames(cfg, model, frames.to(torch.bfloat16))
        fwd["frames"] = frames
    cache = M.init_cache(cfg, B, 64, enc)
    need(cache[next(iter(cache))].device.type == "cuda", "cache off the card")
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(cfg, model, toks[:, t], t, cache, enc)
        outs.append(lg)
    step = torch.stack(outs, 1).float()
    full = M.forward(cfg, model, fwd).float()
    need(step.device.type == full.device.type == "cuda", "logits off the card")
    need(torch.isfinite(full).all().item(), f"{cfg.name}: non-finite logits")
    need(torch.allclose(step, full, atol=DEC_ATOL, rtol=DEC_RTOL),
         f"{cfg.name}: decode differs from forward")
    return (step - full).abs().max().item()


def serve_phase(gen) -> dict:
    """The model server on the card: Qwen3-1.7B at full width and depth
    (seeded bf16 weights), its degraded coded self-check, the host-solve
    self-check of every arch at smoke width, greedy decode through
    `launch.serve.serve` beside the weight-read bound, decode against
    forward at full width and at every arch's smoke width.  Every leg with
    the launch counts set to 0 just before and read just after; returns
    each kernel's launches summed."""
    import contextlib
    import io

    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference
    from repro_torch.obs import trace

    total = dict.fromkeys(DESIGNS, 0)
    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = M.init_params(cfg, gen)  # device None: the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = M.param_count(model)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    need(all(p.device.type == "cuda" for p in model.parameters()),
         "parameters off the card")
    need(params == QWEN3_PARAMS, f"{params} parameters, not {QWEN3_PARAMS}")
    need(nbytes == QWEN3_BYTES, f"{nbytes} parameter bytes, not {QWEN3_BYTES}")
    print(json.dumps({"serve_model": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab,
                      "params": params, "param_bytes": nbytes,
                      "init_s": init_s, "card": CARD}))

    # -- the degraded coded self-check on the parameter tree --------------
    tree = to_reference(model)
    tree_bytes = sum(v.numel() * v.element_size()
                     for v in tree_leaves(tree))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with RssPeak() as rss, trace.installed() as tr:
        full, wall, counts = counted(
            "selfcheck", lambda: LS._coded_selfcheck(tree, 8, 2, degraded=True),
            total)
    shard_w = full.shape[1]
    del full, tree
    stages: dict = {}
    for e in tr.events():
        key = f"{e.get('cat', '')}.{e['name']}"
        stages[key] = stages.get(key, 0.0) + e["dur"] / 1e3
    need(counts["ntt"] >= 1 and counts["gf_matmul"] >= 1,
         f"self-check launches {counts}")
    print(json.dumps({"selfcheck": "degraded (DecodePlan), rs K=8 R=2",
                      "tree": "whole", "tree_bytes": tree_bytes,
                      "symbols": tree_bytes // 2, "shard_w": shard_w,
                      "wall_ms": wall, "stages_ms": stages,
                      "host_peak_gb": rss.peak / 1e9,
                      "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "launches": counts, "bitwise": True, "card": CARD}))

    # -- the host-solve self-check on every arch at smoke width ------------
    for arch in ARCH_IDS:
        if arch == "paper_rs":
            continue
        scfg = get_config(arch).smoke()
        stree = to_reference(M.init_params(scfg, gen))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            full, wall, counts = counted(
                f"selfcheck {arch}", lambda: LS._coded_selfcheck(stree, 8, 2),
                total)
            cpu = LS._coded_selfcheck(stree, 8, 2, device="cpu")
        need(out.getvalue().count("coded self-check OK (host solve)") == 2,
             out.getvalue())
        need(np.array_equal(full, cpu), f"{arch}: card codeword != CPU's")
        need(counts["ntt"] >= 1 and counts["gf_matmul"] >= 1,
             f"{arch}: self-check launches {counts}")
        print(json.dumps({"selfcheck": "host solve (reconstruct -> gf_solve)",
                          "arch": arch, "shard_w": full.shape[1],
                          "wall_ms": wall, "launches": counts,
                          "equal_to_cpu": True}))

    # -- serve: greedy decode at B = 4, prompt 16, 32 new tokens -----------
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen, device="cuda")
    LS.serve(cfg, model, prompt[:, :4], 2)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    res, _, counts = counted("serve", lambda: LS.serve(cfg, model, prompt, G),
                             total)
    need(res.tokens.shape == (B, P + G) and res.tokens.device.type == "cuda",
         res.tokens.shape)
    need(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
         "token out of the vocabulary")
    need(torch.isfinite(res.logits.float()).all().item(), "non-finite logits")
    busy_ms, kernels = device_profile(lambda: LS.serve(cfg, model, prompt, G))
    bound_ms = QWEN3_BYTES / HBM_BYTES_PER_S * 1e3
    print(json.dumps({
        "serve": f"{cfg.name} greedy decode, bf16", "batch": B, "prompt": P,
        "gen": G, "steps": res.steps, "wall_ms": res.wall_s * 1e3,
        "ms_per_token": res.ms_per_token, "tokens_per_s": res.tokens_per_s,
        "weight_read_bound_ms": bound_ms,
        "bound_source": "3,441,397,760 parameter bytes / 3.35 TB/s (data "
                        "sheet): arithmetic, not a measurement",
        "profiled_device_busy_ms": busy_ms,
        "profiled_device_busy_ms_per_step": busy_ms / res.steps,
        "profiled_kernels_per_step": kernels / res.steps,
        "device_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts, "card": CARD}))

    # -- decode equals forward, full width ---------------------------------
    fwd = M.forward(cfg, model, {"tokens": res.tokens[:, :res.steps]}).float()
    step = res.logits.float()
    err = (step - fwd).abs().max().item()
    need(torch.allclose(step, fwd, atol=DEC_ATOL, rtol=DEC_RTOL),
         f"full width: decode differs from forward by {err}")
    print(json.dumps({"decode_vs_forward": cfg.name, "positions": res.steps,
                      "max_abs_diff": err, "atol": DEC_ATOL, "rtol": DEC_RTOL}))
    del model, res, fwd, step
    torch.cuda.empty_cache()

    # -- every arch at smoke width: decode equals forward ------------------
    errs = {}
    for arch in ARCH_IDS:
        if arch == "paper_rs":
            continue
        scfg = get_config(arch).smoke()
        errs[arch] = decode_vs_forward(scfg, M.init_params(scfg, gen), gen)
    print(json.dumps({"decode_vs_forward_smoke": errs, "atol": DEC_ATOL,
                      "rtol": DEC_RTOL}))
    return total


def tree_bytes(tree) -> int:
    from repro_torch.core.pytree import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def on_card(tree) -> bool:
    from repro_torch.core.pytree import tree_flatten

    return all(t.device.type == "cuda" for t in tree_flatten(tree)[0])


def device_profile(fn, calls: int = 1) -> tuple[float, float]:
    """(device busy ms, device events: kernels, copies, fills) a call over
    `calls` calls of `fn`, from `torch.profiler`: the device events'
    durations summed.  (Summing `key_averages()` counts each kernel twice,
    once under its own name and once under the operator that launched
    it.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in device) / 1e3
    return busy_ms / calls, len(device) / calls


def train_phase(gen) -> dict:
    """Training on the card.  (1) Qwen3-1.7B at full width and depth, bf16,
    AdamW, remat on: 20 steps through `launch.train.train` at the JAX
    launcher's defaults, beside the FLOP bound; (2) microbatches=2 and int8
    compression from one state; (3) the straggler-coded step at full
    width: deterministic, and bitwise equal under stragglers {0}, {1},
    {3}; {0, 1} refused before any kernel; (4) the launcher's
    failure-injection scenario at smoke width on the card (the parity
    encode and the degraded restore launch `ntt` and `gf_matmul`);
    (5) every arch's smoke-width `value_and_grad`.  Each leg with the
    launch counts set to 0 just before and read just after; returns each
    kernel's launches summed and the trained full-width state (the dist
    phase's)."""
    import contextlib
    import io
    import statistics
    import tempfile

    import torch

    from repro_torch.coding import GradientCoder
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.pytree import tree_flatten, tree_map
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as LT
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference
    from repro_torch.obs import trace
    from repro_torch.train import (init_state, make_straggler_train_step,
                                   make_train_setup, make_train_step)

    total = dict.fromkeys(DESIGNS, 0)
    cfg = get_config(SERVE_ARCH)
    need(cfg.remat, "the full config trains with remat")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    opt, lr = make_train_setup(cfg, total_steps=TRAIN_STEPS, peak_lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    box = {"state": init_state(cfg, gen, opt)}  # device None: the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state = box["state"]
    n_params = sum(t.numel() for t in tree_flatten(state.params)[0])
    need(on_card(state), "train state off the card")
    need(n_params == QWEN3_PARAMS, f"{n_params} parameters, not {QWEN3_PARAMS}")
    need(tree_bytes(state) == QWEN3_STATE_BYTES,
         f"{tree_bytes(state)} state bytes, not {QWEN3_STATE_BYTES}")
    print(json.dumps({"train_model": cfg.name, "layers": cfg.n_layers,
                      "d_model": cfg.d_model, "vocab": cfg.vocab,
                      "params": n_params, "param_bytes": tree_bytes(state.params),
                      "state_bytes": tree_bytes(state), "optimizer": "adamw",
                      "remat": cfg.remat, "init_s": init_s, "card": CARD}))
    del state

    # -- (1) 20 plain steps through the launcher's loop --------------------
    data = SyntheticLM(cfg.vocab, S, B)
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    res, wall, counts = counted(
        "train", lambda: LT.train(box.pop("state"), lambda st, b, i: step(st, b),
                                  data, TRAIN_STEPS, lr=lr), total)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res.losses
    need(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
         f"losses {losses}")
    need(losses[-1] < losses[0], f"loss did not fall: {losses}")
    need(on_card(res.state) and int(res.state.step) == TRAIN_STEPS,
         "trained state off the card")
    ms = statistics.median(res.step_s[1:]) * 1e3
    st = res.state
    b0 = data.device_batch(0)
    grads_like = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                                device="cuda").to(p.dtype),
                          st.params)
    opt_ms = time_ms(lambda: opt.update(grads_like, st.opt_state, st.params,
                                        st.step), reps=3)
    del grads_like
    vg_ms = time_ms(lambda: M.value_and_grad(cfg, st.params, b0), reps=3)
    busy_ms, kernels = device_profile(lambda: step(st, b0), 2)
    need(kernels > 0, "the profiler saw no kernel")
    flop = 6 * QWEN3_PARAMS * B * S
    print(json.dumps({
        "train": f"{cfg.name} full width and depth, bf16, AdamW, remat",
        "batch": B, "seq": S, "steps": TRAIN_STEPS, "peak_lr": TRAIN_LR,
        "losses": losses, "wall_s": wall / 1e3,
        "first_step_ms": res.step_s[0] * 1e3, "median_ms_per_step": ms,
        "tokens_per_s": B * S / (ms / 1e3),
        "flop_per_step": flop, "flop_per_step_remat": flop * 8 // 6,
        "bound_ms": flop / BF16_FLOP_PER_S * 1e3,
        "bound_ms_remat": flop * 8 / 6 / BF16_FLOP_PER_S * 1e3,
        "bound_source": "6 (8 with remat) x 1,720,574,976 x 1024 tokens / "
                        "989 TFLOP/s bf16 dense (data sheet, 700 W): "
                        "arithmetic, not a measurement",
        "value_and_grad_ms": vg_ms, "optimizer_update_ms": opt_ms,
        "profiled_device_busy_ms_per_step": busy_ms,
        "profiled_kernels_per_step": kernels,
        "device_peak_gb": peak_gb, "launches": counts, "card": CARD}))
    del res

    # -- (2) microbatches and compression from one state -------------------
    def one(fn):
        new, m = fn(st, b0)
        out = (float(m["loss"]), float(m["grad_norm"]))
        need(on_card(new), "step result off the card")
        return out

    (l1, g1), _, _ = counted("step mb1", lambda: one(step), total)
    (l2, g2), _, _ = counted("step mb2",
                              lambda: one(make_train_step(cfg, opt, 2)), total)
    (l3, g3), _, _ = counted(
        "step int8", lambda: one(make_train_step(cfg, opt,
                                                 compress_grads=True)), total)
    need(abs(l2 - l1) <= 2e-2 * abs(l1), f"microbatched loss {l2} vs {l1}")
    need(np.isfinite([l3, g3]).all(), f"compressed step {l3} {g3}")
    print(json.dumps({"train_variants": cfg.name, "loss_mb1": l1,
                      "loss_mb2": l2, "rtol": 2e-2, "grad_norm_mb1": g1,
                      "grad_norm_mb2": g2, "loss_int8": l3,
                      "grad_norm_int8": g3}))

    # -- (3) the straggler-coded step at full width --------------------------
    coder = GradientCoder(4, s=1)
    coded = make_straggler_train_step(cfg, opt, coder)
    walls, peaks = {}, {}

    def coded_params(dead):
        alive = np.isin(np.arange(4), list(dead), invert=True)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        new, m = coded(st, b0, alive)
        loss = m["loss"].clone()
        torch.cuda.synchronize()
        walls[str(sorted(dead))] = (time.perf_counter() - t) * 1e3
        peaks[str(sorted(dead))] = torch.cuda.max_memory_allocated() / 1e9
        need(on_card(new), "coded step result off the card")
        return tree_flatten(new.params)[0], loss

    ref, ref_loss = coded_params(())
    again, again_loss = coded_params(())
    need(torch.equal(ref_loss, again_loss)
         and all(torch.equal(a, b) for a, b in zip(ref, again)),
         "the all-alive coded step is not deterministic")
    del again
    for dead in ({0}, {1}, {3}):
        got, loss = coded_params(dead)
        need(torch.equal(loss, ref_loss)
             and all(torch.equal(a, b) for a, b in zip(got, ref)),
             f"stragglers {sorted(dead)}: params differ from all-alive")
        del got
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        try:
            coded(st, b0, np.array([False, False, True, True]))
            refused = False
        except RuntimeError as exc:
            refused = "fully straggled" in str(exc)
        torch.cuda.synchronize()
    launched = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    need(refused and launched == 0,
         f"stragglers [0, 1]: refused={refused}, {launched} kernels")
    print(json.dumps({"coded_step": cfg.name, "workers": 4, "s": 1,
                      "batch": B, "deterministic": True,
                      "bitwise_under": [[0], [1], [3]],
                      "refused_before_launch": [0, 1],
                      "wall_ms": walls, "device_peak_gb": peaks,
                      "card": CARD}))
    del ref, b0, step, coded  # st goes on to the dist phase
    torch.cuda.empty_cache()

    # -- (4) the launcher's failure-injection scenario, smoke width ---------
    with tempfile.TemporaryDirectory() as td, trace.installed() as tr:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lres, wall, counts = counted(
                "launcher", lambda: LT.main(LAUNCH_ARGV + ["--ckpt-dir", td]),
                total)
    text = out.getvalue()
    print(text, end="")
    for want in ("reconstructed from parity", "selfcheck OK", "done: final loss"):
        need(want in text, f"launcher printed no {want!r}")
    need(on_card(lres.state), "launcher state off the card after the restore")
    need(counts["ntt"] >= 1 and counts["gf_matmul"] >= 1,
         f"launcher leg launches {counts}")
    spans: dict = {}
    for e in tr.events():
        key = f"{e.get('cat', '')}.{e['name']}"
        spans[key] = spans.get(key, 0.0) + e["dur"] / 1e3
    print(json.dumps({"launcher": "failure injection + stragglers, smoke width",
                      "argv": LAUNCH_ARGV, "wall_s": wall / 1e3,
                      "ckpt_ops_ms": [[op, s, sec * 1e3]
                                      for op, s, sec in lres.ckpt_ops],
                      "state_bytes": tree_bytes(lres.state),
                      "stages_ms": spans, "launches": counts, "card": CARD}))
    del lres

    # -- (5) every arch at smoke width: one value_and_grad -----------------
    finite = {}
    for arch in ARCH_IDS:
        if arch == "paper_rs":
            continue
        scfg = get_config(arch).smoke()
        params = to_reference(M.init_params(scfg, gen))
        batch = {"tokens": torch.randint(0, scfg.vocab, (2, 32), generator=gen,
                                         device="cuda"),
                 "labels": torch.randint(0, scfg.vocab, (2, 32), generator=gen,
                                         device="cuda")}
        if scfg.family == "vlm":
            batch["vision_embeds"] = torch.randn(
                (2, scfg.n_patches, scfg.d_model), generator=gen, device="cuda")
        if scfg.family == "encdec":
            batch["frames"] = torch.randn((2, scfg.n_frames, scfg.d_model),
                                          generator=gen, device="cuda")
        loss, grads = M.value_and_grad(scfg, params, batch)
        need(on_card(grads), f"{arch}: gradients off the card")
        need(all(torch.isfinite(g.float()).all().item()
                 for g in tree_flatten(grads)[0]), f"{arch}: non-finite grads")
        new = tree_map(lambda p, g: p - 0.5 * g.to(p.dtype), params, grads)
        loss2 = float(M.loss_fn(scfg, new, batch))
        need(np.isfinite(loss2), f"{arch}: non-finite loss after SGD")
        finite[arch] = [float(loss), loss2]
    print(json.dumps({"value_and_grad_smoke": finite, "grads_finite": True}))
    return total, st


def dryrun_phase() -> None:
    """(a) The port's dry-run, host only: each cell of DRYRUN_CELLS in its
    own `python -m repro_torch.launch.dryrun`, all started together with
    no card visible (a fake process group of 256 or 512 ranks, meta
    DTensors); one line per cell with its per-device census and both
    rooflines."""
    import tempfile

    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--mesh", mesh, "--out-dir", out, "--force"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for arch, shape, mesh in DRYRUN_CELLS]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for (arch, shape, mesh), p, log in zip(DRYRUN_CELLS, procs, logs):
            name = f"{arch} x {shape} x {mesh}"
            need(p.returncode == 0, f"dryrun {name}: rc {p.returncode}\n"
                                    f"{log[-3000:]}")
            with open(os.path.join(out, f"{arch}__{shape}__{mesh}.json")) as f:
                cell = json.load(f)
            need("error" not in cell, f"dryrun {name}: {cell.get('error')}")
            need(cell["n_devices"] == (512 if mesh == "multi" else 256),
                 f"dryrun {name}: {cell['n_devices']} devices")
            need(cell["hlo_flops_per_device"] > 0, f"dryrun {name}: no FLOPs")
            print(json.dumps({
                "dryrun": name, "n_devices": cell["n_devices"],
                "flops_per_device": cell["hlo_flops_per_device"],
                "bytes_per_device": cell["hlo_bytes_per_device"],
                "collective_bytes_per_device":
                    cell["collectives"]["total"]["weighted_bytes"],
                "collectives_by_kind": cell["collectives"]["per_kind"],
                "dominant": cell["roofline"]["dominant"],
                "roofline_tpu_v5e": cell["roofline"],
                "roofline_h100": cell["roofline_h100"],
                "model_flops_per_device": cell["model_flops_per_device"],
                "useful_ratio": cell["useful_ratio"],
                "argument_bytes": cell["memory"]["argument_bytes"],
                "trace_s": cell["lower_s"]}))
    print(json.dumps({"dryrun_cells": len(DRYRUN_CELLS), "wall_s": wall,
                      "host_only": True}))


def dtensor_equal(got, want) -> bool:
    """Every leaf of `got` a DTensor whose local tensor equals the plain
    leaf of `want` bitwise; prints the first leaf that is not."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.core.pytree import tree_flatten

    a, b = tree_flatten(got)[0], tree_flatten(want)[0]
    if len(a) != len(b):
        print(json.dumps({"dtensor_mismatch": "leaves", "got": len(a),
                          "want": len(b)}))
        return False
    for i, (x, y) in enumerate(zip(a, b)):
        local = x.to_local() if isinstance(x, DTensor) else None
        plain = (isinstance(local, torch.Tensor)
                 and not isinstance(local, DTensor)
                 and not isinstance(y, DTensor))
        if plain and local.shape == y.shape and torch.equal(local, y):
            continue
        print(json.dumps({
            "dtensor_mismatch": i, "got": type(x).__name__,
            "local": type(local).__name__, "want": type(y).__name__,
            "shape": list(y.shape),
            "placements": str(getattr(x, "placements", None)),
            "max_abs_diff": (local.float() - y.float()).abs().max().item()
            if plain and local.shape == y.shape else None}))
        return False
    return True


def constrain_phase(state, gen) -> dict:
    """(b) `constrain` on the card: the training phase's full-width
    Qwen3-1.7B state, a batch and a decode cache as DTensors on a 1x1
    ("data", "model") mesh over a one-rank NCCL group (placed by the specs
    with `from_local`: no copy), then `value_and_grad`, one train step and
    DIST_DECODE greedy decode steps inside `activation_sharding`, each
    against the plain run bitwise, under deterministic algorithms; ms per
    step and per token with DTensor beside plain, in turns.  Returns the
    kernels' launches (none is on this path)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import activation_sharding
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import model as M
    from repro_torch.models.convert import holding
    from repro_torch.train import make_train_setup, make_train_step

    total = dict.fromkeys(DESIGNS, 0)
    cfg = get_config(SERVE_ARCH)
    n_params = sum(t.numel() for t in tree_flatten(state.params)[0])
    need(n_params == QWEN3_PARAMS, f"{n_params} parameters, not {QWEN3_PARAMS}")
    need(on_card(state), "train state off the card")
    opt, _ = make_train_setup(cfg, total_steps=TRAIN_STEPS, peak_lr=TRAIN_LR)
    step = make_train_step(cfg, opt)
    batch = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH).device_batch(0)
    first = torch.randint(0, cfg.vocab, (SERVE_BATCH,), generator=gen,
                          device="cuda")

    def greedy(model, cache, tok):
        logits = []
        for i in range(DIST_DECODE):
            out, cache = M.decode_step(cfg, model, tok, i, cache)
            logits.append(out)
            tok = out.argmax(-1)
        return logits

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    was = torch.are_deterministic_algorithms_enabled()
    dist.init_process_group(DIST_BACKEND, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        torch.use_deterministic_algorithms(True)
        mesh = init_device_mesh(DIST_MESH_DEVICE, (1, 1),
                                mesh_dim_names=("data", "model"))
        sizes = mesh_axis_sizes(mesh)
        sspec = type(state)(
            shd.PartitionSpec(),
            shd.param_specs(cfg, state.params, sizes, False),
            shd.opt_state_specs(cfg, state.params, state.opt_state, sizes,
                                False))
        dstate = shd.from_local(state, sspec, mesh)
        dbatch = shd.from_local(batch, shd.batch_specs(cfg, batch, sizes,
                                                       False), mesh)
        need(all(x.to_local().data_ptr() == y.data_ptr() for x, y in zip(
            tree_flatten(dstate)[0], tree_flatten(state)[0])),
             "from_local copied a leaf")

        def scoped(fn):
            def run():
                with activation_sharding(mesh), implicit_replication():
                    return fn()
            return run

        # value_and_grad: the loss and every gradient
        (loss_p, grads_p), vg_p, _ = counted(
            "dist vg plain", lambda: M.value_and_grad(cfg, state.params, batch),
            total)
        (loss_d, grads_d), vg_d, _ = counted(
            "dist vg dtensor", scoped(
                lambda: M.value_and_grad(cfg, dstate.params, dbatch)), total)
        need(dtensor_equal(loss_d, loss_p), "DTensor loss differs")
        need(dtensor_equal(grads_d, grads_p), "DTensor gradients differ")
        n_grads = len(tree_flatten(grads_p)[0])
        del grads_p, grads_d

        # one train step: the loss, the grad norm, the new parameters
        (new_p, m_p), step_p, _ = counted(
            "dist step plain", lambda: step(state, batch), total)
        params_p = new_p.params
        del new_p
        (new_d, m_d), step_d, _ = counted(
            "dist step dtensor", scoped(lambda: step(dstate, dbatch)), total)
        need(dtensor_equal(m_d["loss"], m_p["loss"])
             and dtensor_equal(m_d["grad_norm"], m_p["grad_norm"]),
             "DTensor step metrics differ")
        need(dtensor_equal(new_d.params, params_p),
             "DTensor step params differ")
        del new_d, params_p

        # ms per step in turns: plain, DTensor, DTensor, plain
        turns = {"plain": [], "dtensor": []}
        for kind in ("plain", "dtensor", "dtensor", "plain"):
            fn = ((lambda: step(state, batch)) if kind == "plain"
                  else scoped(lambda: step(dstate, dbatch)))
            out, ms = walled(fn)
            del out
            turns[kind].append(ms)

        # DIST_DECODE greedy decode steps, every step's logits
        model_p, model_d = holding(cfg, state.params), holding(cfg,
                                                               dstate.params)
        cache = M.init_cache(cfg, SERVE_BATCH, DIST_DECODE)
        logits_p, dec_p = walled(lambda: greedy(model_p, cache, first))
        cache = M.init_cache(cfg, SERVE_BATCH, DIST_DECODE)
        dcache = shd.from_local(cache, shd.cache_specs(cfg, cache, sizes,
                                                       False), mesh)
        dfirst = shd.from_local(first, shd.batch_specs(cfg, first, sizes,
                                                       False), mesh)
        logits_d, dec_d = walled(scoped(
            lambda: greedy(model_d, dcache, dfirst)))
        need(dtensor_equal(logits_d, logits_p), "DTensor decode logits differ")
        del cache, dcache, model_p, model_d
    finally:
        torch.use_deterministic_algorithms(was)
        dist.destroy_process_group()
    need(not dist.is_initialized(), "process group left behind")
    print(json.dumps({
        "constrain_on_card": f"{cfg.name} full width and depth",
        "mesh": "1x1 (data, model)", "backend": DIST_BACKEND,
        "deterministic": True, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "bitwise": {"loss": True, "gradients": n_grads, "new_params": True,
                    "decode_logits": DIST_DECODE},
        "value_and_grad_ms": {"plain": vg_p, "dtensor_first": vg_d},
        "step_ms": {"plain": step_p, "dtensor_first": step_d},
        "step_ms_in_turns": turns,
        "decode_ms_per_token": {"plain": dec_p / DIST_DECODE,
                                "dtensor": dec_d / DIST_DECODE},
        "phase_s": time.perf_counter() - t0, "launches": total,
        "card": CARD}))
    return total


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    global CARD
    CARD = card_line()
    print(CARD)
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
    cluster_lines(logs)
    imma = sass_count(build, "gf_matmul", "IMMA")
    print(json.dumps({"sass": "gf_matmul", "imma_instructions": imma}))
    need(imma > 0, "no integer tensor-core instruction in gf_matmul's SASS")
    wide = sass_count(build, "gf_matmul_small", r"IMAD\.WIDE\.U32")
    print(json.dumps({"sass": "gf_matmul_small", "imad_wide_u32": wide}))
    need(wide > 0, "no 64-bit multiply-add in gf_matmul_small's SASS")

    print(json.dumps({"peaks": {
        "hbm_bytes_per_s": HBM_BYTES_PER_S, "int8_mac_per_s": INT8_MAC_PER_S,
        "int32_mad_per_s": INT32_MAD_PER_S,
        "source": "H100 SXM data sheet (3.35 TB/s; 1,979 T int8 ops/s dense; "
                  "67 TFLOP/s float32 = 128 FMA lanes/SM) and the Hopper "
                  "white paper (64 INT32 lanes/SM): INT32 multiply-adds at "
                  "half the FMA rate"}}))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary = kernel_phase(gen)
    summary["gf_matmul_batched"] = batched_kernel_phase(gen)
    launches = main_path_phase()
    for name, n in mesh_phase().items():
        launches[name] += n
    for name, n in stream_phase().items():
        launches[name] += n
    simulator_phase()
    for phase in (solve_phase, lambda: checkpoint_phase(gen),
                  lambda: coding_phase(gen), service_phase,
                  lambda: serve_phase(gen)):
        for name, n in phase().items():
            launches[name] += n
    counts, state = train_phase(gen)
    dryrun_phase()
    counts = {k: n + counts[k] for k, n in constrain_phase(state, gen).items()}
    del state
    for name, n in counts.items():
        launches[name] += n

    sources = {"gf_matmul": ("src/repro_torch/csrc/gf_matmul.cu",
                             "src/repro/kernels/gf_matmul.py:53"),
               "ntt": ("src/repro_torch/csrc/ntt.cu",
                       "src/repro/kernels/ntt.py:80"),
               "ntt_slab": ("src/repro_torch/csrc/ntt.cu",
                            "src/repro/kernels/ntt.py:80"),
               "ntt_cluster": ("src/repro_torch/csrc/ntt.cu",
                               "src/repro/kernels/ntt.py:80"),
               "gf_matmul_batched": ("src/repro_torch/csrc/gf_matmul_small.cu",
                                     "src/repro/kernels/gf_matmul.py:53")}
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
        if "designs" in s:  # gf_matmul_batched, ntt_cluster: both designs
            kernels[-1]["designs"] = s["designs"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
