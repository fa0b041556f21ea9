#!/usr/bin/env python3
"""Where the one-pass cluster NTT kernel's time goes on one NVIDIA GPU.

    python3 tools/ntt_cluster_probe.py

Prints the card's name and power limit, ptxas's register and spill lines
for every `ntt_cluster` instance, and per Z the launch facts
(`ntt.cluster_config`: blocks a cluster, shared bytes a block, columns a
cluster, `cudaOccupancyMaxActiveClusters`, registers and local bytes from
the runtime).  Then, at Z = 2^13 .. 2^16 with 2^25 or 2^26 elements, holds
`ntt(x, _route="cluster")` and the forced two-pass route bitwise against
`ntt_plain` in both directions, and times with CUDA events, in turns
(cluster, two-pass, two-pass, cluster): the cluster kernel, the two-pass
route (`ntt_outer` and `ntt_slab`), `ntt_outer` alone and a device copy of
the same bytes.  Beside them, by a direct launch, the library as built
(`as_built`) and edited copies of `src/repro_torch/csrc/ntt.cu` built into
the ignored `src/repro_torch/_build/probe/`:

  local       every block exchanges with its own shared memory in place
              of its peers' (`map_shared_rank` -> `s`): the same kernel
              without the traffic between SMs (output wrong, not checked);
  no_stagger  every block of a cluster stores to (loads from) ranks 0, 1,
              ... in the same order, no local first turn (checked);
  old_fold    the 32-bit product folded as (p & 0xFFFF) + q - (p >> 16)
              then a min, in every kernel of the file (checked); also timed
              for `ntt_slab` at (4096, 2^12) and `ntt_regs` at (64, 2^20);
  rows4096    blocks of 4096 rows below Z = 2^16 too (512 threads, one
              block an SM, where the kernel has 2048 rows and two blocks an
              SM) (checked);
  memory      no arithmetic in the cluster kernel (no stages, no twists):
              its loads, exchange, barriers and stores alone;
  compute     no loads from device memory in the cluster kernel (values
              made from the indices): its arithmetic, exchange and stores;
  attrs_each_launch
              the kernel's function attributes set at every launch, not
              once a device (timed, not checked).

Then, at (65536, 2^10), the cluster kernel and the two-pass route with
their arrays at offsets of 0 to 32 MB (`placement`).  Last, at (8192,
2^12) forward, the wrapper's cost: host microseconds a call to enqueue 200
calls (no synchronise inside) and the device time a call, for `ntt(x)`,
the direct launch and the direct launch of `attrs_each_launch`, in turns.
One JSON line per (Z, direction).  Needs a CUDA card and nvcc; exits
nonzero without them.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
Q = 65537
SHAPES = [(1 << 13, 1 << 12), (1 << 14, 1 << 11), (1 << 15, 1 << 11),
          (1 << 16, 1 << 10)]
PEER = "cluster.map_shared_rank(s, (rank + d) & (Z0 - 1))"
NO_OP = "(void)0;"
EDITS = {
    "local": [(PEER, "(s + 0 * d)")],
    "no_stagger": [
        ("    rotate_groups<L0, NI>(v, rank);  // v[k Z0 + d]: value rank + d\n", ""),
        (f"d == 0 ? s : {PEER}", "cluster.map_shared_rank(s, d)"),
        ("    rotate_groups<L0, NI>(v, (Z0 - rank) & (Z0 - 1));  // v[k Z0 + a]: value a\n",
         "")],
    "old_fold": [("  const uint32_t r = p - (p >> 16) * kQ;\n  return min(r, r + kQ);",
                  "  const uint32_t r = (p & 0xFFFFu) + kQ - (p >> 16);\n"
                  "  return min(r, r - kQ);")],
    "rows4096": [(f"case {h}: return fn.template run<{h - 11}, 5>();",
                  f"case {h}: return fn.template run<{h - 12}, 6>();")
                 for h in (13, 14, 15)],
    "memory": [(stmt, NO_OP) for stmt in (
        "dif<L0, false>(v + k * Z0, tw.w0);", "dif<L0, true>(v + k * Z0, tw.w0);",
        "dif<L1, false>(v, tw.pass.w1);", "dif<L1, true>(v, tw.pass.w1);",
        "dif<6, false>(v, tw.pass.w2);", "dif<6, true>(v, tw.pass.w2);",
        "twist_row<64, false>(v, stwist + p * 64);",
        "twist_row<64, true>(v, stwist + p * 64);",
        "v[k * Z0 + a] = mulmod_tw(v[k * Z0 + a], __ldg(otwist + a * R + j0 + k * Z1));",
        "v[k * Z0 + a] = mulmod(v[k * Z0 + a], __ldg(otwist + a * R + j0 + k * Z1));")],
    "compute": [
        ("v[k * Z0 + a] = live ? __ldcs(xj + (long long)(k * Z1 + a * R) * C) : 0u;",
         "v[k * Z0 + a] = (uint32_t)(j0 * 977 + k * 13 + a * 31 + blockIdx.x) & 0xFFFFu;"),
        ("for (int i = 0; i < 64; ++i) v[i] = live ? __ldcs(xb + (long long)i * C) : 0u;",
         "for (int i = 0; i < 64; ++i) "
         "v[i] = (uint32_t)(p * 977 + i * 13 + c * 31 + blockIdx.x) & 0xFFFFu;")],
    "attrs_each_launch": [
        ("  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;\n", "")],
}
CHECKED = ("as_built", "no_stagger", "old_fold", "rows4096")


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


def typed(lib):
    """`lib` with the argument types of its launch entries: pointers and
    the stream as `c_void_p` (ctypes would pass a bare int as 32 bits)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ntt_cluster_launch.argtypes = [ptr] * 5 + [i32, i64, i32, ptr]
    lib.ntt_slab_launch.argtypes = [ptr] * 4 + [i32, i64, i32, i32, ptr]
    lib.ntt_regs_launch.argtypes = [ptr] * 3 + [i32, i64, ctypes.c_uint, i32, ptr]
    for fn in (lib.ntt_cluster_launch, lib.ntt_slab_launch, lib.ntt_regs_launch):
        fn.restype = ctypes.c_int
    return lib


def build_variants(build) -> dict:
    """{variant: its loaded library}, one nvcc per variant, all at once;
    "as_built": the package's own library."""
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
        cu = out / f"ntt_cluster_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"libcluster_{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"as_built": typed(ctypes.CDLL(str(build.library_path("ntt"))))}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = typed(ctypes.CDLL(str(out / f"libcluster_{name}.so")))
    return libs


def ptxas_lines(log: str) -> list[dict]:
    """ptxas's registers and spill stores of each `ntt_cluster` instance."""
    lines = []
    for fn in re.split(r"Compiling entry function ", log)[1:]:
        args = re.search(r"ntt_cluster\w*?ILi(\d)ELi(\d)ELb([01])E", fn.split("'")[1])
        if not args:
            continue
        lines.append({"ptxas": "ntt_cluster", "cluster_blocks": 1 << int(args.group(1)),
                      "rows": 64 << int(args.group(2)),
                      "inverse": args.group(3) == "1",
                      "registers": int(re.search(r"Used (\d+) registers", fn).group(1)),
                      "spill_store_bytes": int(
                          re.search(r"(\d+) bytes spill stores", fn).group(1))})
    return lines


def tables_4096(mod, Z: int, root: int, scale: int) -> tuple:
    """`cluster_tables` for blocks of 4096 rows (the `rows4096` variant):
    the leading stages' twiddles and twist of the two-pass route's
    `outer_tables`, then the 4096-point slab's twiddles and twist with
    root^(Z / 4096)."""
    import numpy as np

    lead, otwist = mod.outer_tables(Z, root, scale)
    sw, stwist = mod.slab_tables(4096, pow(root, Z // 4096, Q), 1)
    tw = np.zeros(72, np.uint32)
    tw[:len(lead)] = lead
    tw[8:] = sw
    return tw, otwist, stwist


def placement(mod, dev, gen, stream) -> None:
    """At (65536, 2^10), both directions: the cluster kernel and the
    two-pass route by direct launches with x and out at offsets of 0 to
    32 MB inside larger buffers, in turns: how far the kernels' time
    depends on where their arrays lie."""
    import torch

    Z, C = 1 << 16, 1 << 10
    n, pad = Z * C, 1 << 23  # words: 256 MB arrays, up to 32 MB of offset
    xs = torch.randint(0, Q, (n + pad,), generator=gen, device=dev, dtype=torch.int32)
    outs = torch.empty(n + pad, device=dev, dtype=torch.int32)
    offsets = (0, 1 << 14, 1 << 18, 1 << 19, 1 << 21, 1 << 22, 1 << 23)
    for inverse in (False, True):
        root, scale = mod.roots(Z, inverse)
        line = {"placement": {"Z": Z, "C": C, "inverse": inverse}, "ms": {}}
        for xo, oo in [(0, o) for o in offsets] + [(o, 0) for o in offsets[1:]]:
            x = xs[xo:xo + n].view(Z, C)
            out = outs[oo:oo + n].view(Z, C)

            def two_pass():
                sub = pow(root, Z // 4096, Q)
                if inverse:
                    mod._slab(x, out, 4096, sub, 1, Z // 4096, True, stream)
                    mod._outer(out, out, Z, root, scale, True, stream)
                else:
                    mod._outer(x, out, Z, root, 1, False, stream)
                    mod._slab(out, out, 4096, sub, 1, Z // 4096, False, stream)

            runs = {"cluster": lambda: mod._cluster(x, out, Z, root, scale, inverse,
                                                    stream),
                    "two-pass": two_pass}
            line["ms"][f"x+{4 * xo}B out+{4 * oo}B"] = {
                k: [time_ms(runs[k]) for _ in range(2)] for k in ("cluster", "two-pass")}
        print(json.dumps(line), flush=True)
    del xs, outs
    torch.cuda.empty_cache()


def other_kernels(mod, libs, dev, gen, stream) -> None:
    """`ntt_slab` at (4096, 2^12) and `ntt_regs` at (64, 2^20), forward,
    as built and with the old fold, in turns."""
    import torch

    for Z, C in ((4096, 1 << 12), (64, 1 << 20)):
        x = torch.randint(0, Q, (Z, C), generator=gen, device=dev,
                          dtype=torch.int32)
        out = torch.empty_like(x)
        root, _ = mod.roots(Z, False)
        if Z == 4096:
            tw, twist = mod._device_twist("slab", Z, root, 1, dev)

            def run(lib):
                return lib.ntt_slab_launch(x.data_ptr(), out.data_ptr(),
                                           twist.data_ptr(), tw.ctypes.data, 12,
                                           C, 1, 0, stream)
        else:
            tw = mod.regs_tables(Z, root)

            def run(lib):
                return lib.ntt_regs_launch(x.data_ptr(), out.data_ptr(),
                                           tw.ctypes.data, 6, C, 1, 0, stream)
        turns = {"as_built": [], "old_fold": []}
        for turn in ("as_built", "old_fold", "old_fold", "as_built"):
            if run(libs[turn]):
                raise RuntimeError(f"launch failed at Z={Z}")
            turns[turn].append(time_ms(lambda lib=libs[turn]: run(lib)))
        print(json.dumps({"kernel": "ntt_slab" if Z == 4096 else "ntt_regs",
                          "Z": Z, "C": C, "turns_ms": turns}), flush=True)


def wrapper_cost(mod, ntt, libs, dev, gen, stream) -> None:
    """Host enqueue time and device time a call at (8192, 2^12) forward:
    the wrapper against a direct launch of the same kernel."""
    import torch

    Z, C = 1 << 13, 1 << 12
    x = torch.randint(0, Q, (Z, C), generator=gen, device=dev, dtype=torch.int32)
    out = torch.empty_like(x)
    root, scale = mod.roots(Z, False)
    tw, otwist, stwist = mod._device_twist("cluster", Z, root, scale, dev)

    def direct(lib):
        return lambda: lib.ntt_cluster_launch(
            x.data_ptr(), out.data_ptr(), otwist.data_ptr(), stwist.data_ptr(),
            tw.ctypes.data, Z.bit_length() - 1, C, 0, stream)

    runs = {"ntt(x)": lambda: ntt(x), "direct": direct(libs["as_built"]),
            "direct_attrs_each_launch": direct(libs["attrs_each_launch"])}
    line = {"Z": Z, "C": C}
    for name in ("ntt(x)", "direct", "direct_attrs_each_launch",
                 "direct_attrs_each_launch", "direct", "ntt(x)"):
        fn = runs[name]
        time_ms(fn)
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        entry = line.setdefault(name, {"host_us": [], "device_ms": []})
        entry["host_us"].append(host_us)
        entry["device_ms"].append(time_ms(fn))
    print(json.dumps({"wrapper_cost": line}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ntt_cluster_probe: needs a CUDA card", file=sys.stderr)
        return 2
    import importlib

    from repro_torch.kernels import build, ntt, ntt_plain

    mod = importlib.import_module("repro_torch.kernels.ntt")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if build.library_path("ntt").exists():
        build.library_path("ntt").unlink()  # rebuild: ptxas's lines
    for line in ptxas_lines(build.build(("ntt",))["ntt"]):
        print(json.dumps(line))
    for Z, rows in mod.CLUSTER_ROWS.items():
        print(json.dumps({"Z": Z, "rows": rows, **mod.cluster_config(Z)}))
    libs = build_variants(build)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    other_kernels(mod, libs, dev, gen, stream)
    for Z, C in SHAPES:
        x = torch.randint(0, Q, (Z, C), generator=gen, device=dev,
                          dtype=torch.int32)
        out = torch.empty_like(x)
        for inverse in (False, True):
            root, scale = mod.roots(Z, inverse)

            def launcher(name, tables):
                tw, otwist, stwist = tables
                dev_tables = [torch.as_tensor(t.astype("int32"), device=dev)
                              for t in (otwist, stwist)]
                return lambda: libs[name].ntt_cluster_launch(
                    x.data_ptr(), out.data_ptr(), dev_tables[0].data_ptr(),
                    dev_tables[1].data_ptr(), tw.ctypes.data, Z.bit_length() - 1,
                    C, int(inverse), stream)

            own = mod.cluster_tables(Z, root, scale)
            variants = {name: launcher(name, own) for name in ["as_built"] + list(EDITS)}
            if Z < 1 << 16:
                variants["rows4096"] = launcher("rows4096", tables_4096(mod, Z, root, scale))
            else:
                del variants["rows4096"]
            want = ntt_plain(x, inverse=inverse)
            for forced in mod.ROUTES:
                if not torch.equal(ntt(x, inverse=inverse, _route=forced).long(), want):
                    raise AssertionError(f"{forced} differs from ntt_plain at Z={Z}")
            for name in CHECKED:
                if name in variants:
                    out.fill_(-1)
                    if variants[name]():
                        raise RuntimeError(f"{name}: launch failed at Z={Z}")
                    if not torch.equal(out.long(), want):
                        raise AssertionError(f"{name} differs from ntt_plain at Z={Z}")
            del want
            turns = {"cluster": [], "two-pass": []}
            time_ms(lambda: ntt(x, inverse=inverse))  # warm-up, not kept
            for turn in ("cluster", "two-pass", "two-pass", "cluster"):
                turns[turn].append(time_ms(
                    lambda t=turn: ntt(x, inverse=inverse, _route=t)))

            def outer():
                mod._outer(x, out, Z, root, scale, inverse, stream)

            line = {"Z": Z, "C": C, "inverse": inverse,
                    "bound_ms": 8 * Z * C / 3.35e12 * 1e3,
                    "copy_ms": time_ms(lambda: out.copy_(x)),
                    "turns_ms": turns, "outer_ms": time_ms(outer)}
            line.update({f"{name}_ms": time_ms(fn) for name, fn in variants.items()})
            print(json.dumps(line), flush=True)
        del x, out
        torch.cuda.empty_cache()
    placement(mod, dev, gen, stream)
    wrapper_cost(mod, ntt, libs, dev, gen, stream)
    return 0


if __name__ == "__main__":
    sys.exit(main())
