"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on DTensors;
the port of `repro/launch/dryrun.py`.

For each cell this writes (into --out-dir, one JSON per cell so runs are
resumable):
  * the per-device census of the traced step (`launch.hlo_cost`): FLOPs,
    the bytes proxy, collective bytes by kind;
  * the argument and output bytes of one rank's shards;
  * roofline terms (compute / memory / collective seconds) + dominant term,
    on the JAX package's TPU v5e model (`roofline`) and on the H100's
    data-sheet peaks (`roofline_h100`);
  * MODEL_FLOPS = 6*N_active*tokens (train) or 2*N_active*tokens (fwd-only)
    and the usefulness ratio MODEL_FLOPS / census FLOPs.

The mesh is a `cuda`-typed `DeviceMesh` over a fake process group of 256
ranks (512 with the pod axis); the parameters, state, batch and cache are
meta DTensors laid out by `dist.sharding`'s specs, so nothing is
allocated, nothing runs on a device, and the run is rank 0's.  What the
JAX dry-run reads from XLA's compile (compile time, temp and code bytes,
XLA's own cost analysis) has no torch analog: those keys are null and
`no_torch_analog` names them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3_14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out-dir results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch import nn

from ..configs import ARCH_IDS, cell_applicable, get_config, get_shape
from ..core.pytree import tree_flatten, tree_map
from ..data.pipeline import make_batch_specs
from ..dist import sharding as shd
from ..dist.ctx import activation_sharding
from ..models import model as M
from ..models.config import ArchConfig, ShapeConfig
from ..models.convert import holding, to_reference
from ..train.state import TrainState, abstract_state, make_train_setup
from ..train.train_loop import make_train_step
from .hlo_cost import trace
from .mesh import (H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_FLOPS,
                   TPU_V5E_HBM_BW, TPU_V5E_ICI_BW, TPU_V5E_PEAK_FLOPS,
                   make_production_mesh, mesh_axis_sizes)

NO_TORCH_ANALOG = ["compile_s", "memory.temp_bytes", "memory.code_bytes",
                   "xla_cost_analysis_unscaled"]


# ---------------------------------------------------------------------------
# analytic model FLOPs (the "useful work" yardstick)
# ---------------------------------------------------------------------------

def active_params(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the config arithmetic."""
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    attn = D * hd * (H + 2 * KV) + H * hd * D if H else 0
    per_layer_dense = attn
    if cfg.family == "ssm":
        DI, N, SH = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per_layer_dense = D * (2 * DI + 2 * N + SH) + DI * D
        ffn_total = ffn_active = 0
    elif cfg.family == "hybrid":
        DI, N, SH = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per_layer_dense += D * (2 * DI + 2 * N + SH) + DI * D
        ffn_total = ffn_active = 3 * D * cfg.d_ff
    elif cfg.n_experts:
        ffn_total = cfg.n_experts * 3 * D * cfg.d_ff + D * cfg.n_experts
        ffn_active = (cfg.top_k + cfg.n_shared_experts) * 3 * D * cfg.d_ff
    else:
        ffn_total = ffn_active = 3 * D * cfg.d_ff
    enc = cfg.n_enc_layers * (attn + 3 * D * cfg.d_ff) if cfg.n_enc_layers else 0
    total = emb + L * (per_layer_dense + ffn_total) + enc
    active = emb + L * (per_layer_dense + ffn_active) + enc
    return total, active


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    _, active = active_params(cfg)
    # PaLM-style convention: matmul params = non-embedding + the unembed
    # projection (a real 2*V*D matmul per token); the embed gather is free.
    non_emb = active - cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    non_emb = non_emb + cfg.vocab * cfg.d_model
    if shape.is_train:
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * non_emb * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * non_emb * tokens
    # decode: one token per sequence + KV attention reads (flops ~ 2*N*B)
    return 2.0 * non_emb * shape.global_batch


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def shard_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def _distribute(tree, specs, mesh):
    """`tree`'s leaves (meta tensors at the global shape) as meta DTensors
    laid out by `specs` on `mesh`, each holding this rank's empty shard."""
    shards = tree_map(lambda t, s: torch.empty(
        shd.local_shape(tuple(t.shape), s, mesh), dtype=t.dtype,
        device="meta"), tree, specs)
    return shd.from_local(shards, specs, mesh)


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, multi_pod: bool):
    """Returns (fn, args as meta DTensors, the args' specs)."""
    sizes = mesh_axis_sizes(mesh)
    scalar = shd.PartitionSpec()

    if shape.is_train:
        opt, _ = make_train_setup(cfg)
        step = make_train_step(cfg, opt, microbatches=1)
        state = abstract_state(cfg, opt)
        batch = make_batch_specs(cfg, shape)
        pspec = shd.param_specs(cfg, state.params, sizes, multi_pod)
        ospec = shd.opt_state_specs(cfg, state.params, state.opt_state, sizes,
                                    multi_pod)
        sspec = TrainState(scalar, pspec, ospec)
        bspec = shd.batch_specs(cfg, batch, sizes, multi_pod)
        args = (_distribute(state, sspec, mesh), _distribute(batch, bspec, mesh))
        return step, args, (sspec, bspec)

    params = to_reference(M.init_params(cfg, device="meta"))
    pspec = shd.param_specs(cfg, params, sizes, multi_pod)
    dparams = _distribute(params, pspec, mesh)
    if shape.kind == "prefill":
        batch = make_batch_specs(cfg, shape)
        bspec = shd.batch_specs(cfg, batch, sizes, multi_pod)

        def prefill(p, b):
            return M.forward(cfg, p, b)

        return (prefill, (dparams, _distribute(batch, bspec, mesh)),
                (pspec, bspec))

    # decode: the cache full to its last position
    B = shape.global_batch
    cache = M.init_cache(cfg, B, shape.seq_len, device="meta")
    cspec = shd.cache_specs(cfg, cache, sizes, multi_pod)
    token = make_batch_specs(cfg, shape)["token"]
    tspec = shd.batch_specs(cfg, token, sizes, multi_pod)
    model = holding(cfg, dparams)
    pos = shape.seq_len - 1
    args = [model, _distribute(token, tspec, mesh), pos,
            _distribute(cache, cspec, mesh)]
    specs = [pspec, tspec, scalar, cspec]
    if cfg.family == "encdec":
        enc = torch.empty((B, cfg.n_frames, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
        espec = shd.batch_specs(cfg, enc, sizes, multi_pod)
        args.append(_distribute(enc, espec, mesh))
        specs.append(espec)

    def decode(p, tok, pos_, c, *enc_out):
        return M.decode_step(cfg, p, tok, pos_, c, *enc_out)

    return decode, tuple(args), tuple(specs)


# ---------------------------------------------------------------------------
# per-cell dry-run
# ---------------------------------------------------------------------------

def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _roofline(flops: float, nbytes: float, coll: float, peak: float,
              hbm: float, link: float) -> dict:
    terms = {"compute_s": flops / peak, "memory_s": nbytes / hbm,
             "collective_s": coll / link}
    return {**terms, "dominant": max(terms, key=terms.get),
            "bound_s": max(terms.values())}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             quantize_kv: bool = False) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch)
    if quantize_kv:
        cfg = dataclasses.replace(cfg, quantize_kv=True)
    shape = get_shape(shape_name)
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": why}
    multi_pod = mesh_kind == "multi"
    _fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        n_dev = mesh.size()
        t0 = time.time()
        fn, args, _ = build_cell(cfg, shape, mesh, multi_pod)
        with activation_sharding(mesh, multi_pod), implicit_replication():
            out, census = trace(fn, *args)
        t_lower = time.time() - t0
        # decode's output holds the cache it wrote in place
        arg_bytes = shard_bytes([list(a.parameters()) if isinstance(
            a, nn.Module) else a for a in args])
        out_bytes = shard_bytes(out)
        del out, args
    finally:
        dist.destroy_process_group()

    coll = {"per_kind": census["collectives_by_kind"],
            "total": {"weighted_bytes": census["collective_bytes"]}}
    flops_dev = float(census["flops"])
    bytes_dev = float(census["bytes"])
    coll_dev = float(census["collective_bytes"])
    roof = _roofline(flops_dev, bytes_dev, coll_dev, TPU_V5E_PEAK_FLOPS,
                     TPU_V5E_HBM_BW, TPU_V5E_ICI_BW)
    roof_h100 = _roofline(flops_dev, bytes_dev, coll_dev, H100_PEAK_FLOPS,
                          H100_HBM_BW, H100_NVLINK_BW)
    mf = model_flops(cfg, shape)
    mf_dev = mf / n_dev
    total_p, active_p = active_params(cfg)

    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "n_devices": n_dev,
        "lower_s": round(t_lower, 1), "compile_s": None,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "code_bytes": None,
        },
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": bytes_dev,
        "xla_cost_analysis_unscaled": None,
        "collectives": coll,
        "roofline": roof,
        "roofline_h100": roof_h100,
        "model_flops_global": mf,
        "model_flops_per_device": mf_dev,
        "useful_ratio": (mf_dev / flops_dev) if flops_dev else None,
        "params_total": total_p,
        "params_active": active_p,
        "roofline_fraction": (mf_dev / TPU_V5E_PEAK_FLOPS)
        / max(roof["bound_s"], 1e-12),
        "no_torch_analog": NO_TORCH_ANALOG,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quantize-kv", action="store_true")
    args = ap.parse_args(argv)

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [a for a in ARCH_IDS if a != "paper_rs"] if args.all else [args.arch]
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"] \
        if args.all else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    for arch in archs:
        for shp in shapes:
            for mk in meshes:
                out = out_dir / f"{arch}__{shp}__{mk}.json"
                if out.exists() and not args.force:
                    print(f"skip (cached): {out.name}")
                    continue
                print(f"=== {arch} x {shp} x {mk} ===", flush=True)
                try:
                    res = run_cell(arch, shp, mk, quantize_kv=args.quantize_kv)
                except Exception as e:  # record failures — they are bugs
                    res = {"arch": arch, "shape": shp, "mesh": mk,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                out.write_text(json.dumps(res, indent=1, default=str))
                if "error" in res:
                    print(f"  ERROR: {res['error'][:300]}", flush=True)
                elif "skipped" in res:
                    print(f"  SKIP: {res['skipped']}", flush=True)
                else:
                    r = res["roofline"]
                    print(f"  lower={res['lower_s']}s "
                          f"dominant={r['dominant']} "
                          f"roofline_frac={res['roofline_fraction']:.3f}",
                          flush=True)


if __name__ == "__main__":
    main()
