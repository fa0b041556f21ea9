"""The port's sharded model code on 4 gloo ranks (a 2 x 2 ("data",
"model") mesh) on the CPU, against the plain run (run by
`test_torch_dist.py` in a subprocess; not collected by pytest).

Every rank builds the same seeded float32 smoke-width model, lays the
parameters, the batch and the decode cache out by `dist.sharding`'s specs
(really sharded: the batch over "data", the largest divisible dimension of
each leaf over "model"), runs `value_and_grad` and 4 greedy decode steps
inside `activation_sharding`, and holds the loss, every gradient and every
decode logit, gathered, against the plain run's within rtol 1e-4, atol
1e-5 (the ranks sum in another order).  This runs the local paths of
`dist.ctx` (`einsum`, `lookup` over a vocab-sharded table, `local_shard`)
and `layers._per_shard` where ranks hold different shards.

    PYTHONPATH=src python tests/torch_dist_sharded_checks.py

Prints 'TORCH_DIST_SHARDED_CHECKS_OK' on success; any failure is fatal.
"""
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

ARCHS = ("qwen3_1_7b", "phi3_5_moe_42b_a6_6b", "mamba2_780m")
WORLD = 4
RTOL, ATOL = 1e-4, 1e-5


def check(arch, mesh) -> dict:
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_map
    from repro_torch.dist import activation_sharding
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models import model as M
    from repro_torch.models.convert import holding, to_reference

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    sizes = mesh_axis_sizes(mesh)
    params = to_reference(M.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu"))
    rng = np.random.default_rng(1)
    B, S = 2, 8
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B,)))

    def place(tree, specs):
        return tree_map(lambda t, s: distribute_tensor(
            t, mesh, shd.placements(s, mesh)), tree, specs)

    tspec = shd.batch_specs(cfg, tokens, sizes, False)

    def greedy(model, cache, tok):
        out = []
        for i in range(4):
            logits, cache = M.decode_step(cfg, model, tok, i, cache)
            out.append(logits)
            if isinstance(logits, DTensor):  # the next tokens, as placed
                tok = place(logits.full_tensor().argmax(-1), tspec)
            else:
                tok = logits.argmax(-1)
        return out

    loss, grads = M.value_and_grad(cfg, params, batch)
    dec = greedy(holding(cfg, params), M.init_cache(cfg, B, 4, device="cpu"),
                 tokens)
    pspec = shd.param_specs(cfg, params, sizes, False)
    dparams = place(params, pspec)
    dbatch = place(batch, shd.batch_specs(cfg, batch, sizes, False))
    cache = M.init_cache(cfg, B, 4, device="cpu")
    dcache = place(cache, shd.cache_specs(cfg, cache, sizes, False))
    dtok = place(tokens, tspec)
    with activation_sharding(mesh), implicit_replication():
        dloss, dgrads = M.value_and_grad(cfg, dparams, dbatch)
        ddec = greedy(holding(cfg, dparams), dcache, dtok)
    sharded = sum(any(p.is_shard() for p in t.placements)
                  for t in tree_flatten(dparams)[0])
    assert sharded > 0, (arch, "nothing sharded")

    def close(got, want, what):
        for i, (g, w) in enumerate(zip(tree_flatten(got)[0],
                                       tree_flatten(want)[0])):
            assert isinstance(g, DTensor), (arch, what, i, type(g))
            g = g.full_tensor()
            assert g.shape == w.shape, (arch, what, i, g.shape, w.shape)
            assert torch.allclose(g, w, rtol=RTOL, atol=ATOL), (
                arch, what, i, (g - w).abs().max().item())

    close(dloss, loss, "loss")
    close(dgrads, grads, "grads")
    close(ddec, dec, "decode logits")
    return {"sharded_leaves": sharded, "leaves": len(tree_flatten(params)[0])}


def rank_main(rank: int, init: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for arch in ARCHS:
            info = check(arch, mesh)
            if rank == 0:
                print(f"{arch}: loss, grads, decode within rtol {RTOL} "
                      f"on 2x2 ({info['sharded_leaves']} of {info['leaves']} "
                      f"leaves sharded)", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as td:
        init = "file://" + os.path.join(td, "rendezvous")
        mp.start_processes(rank_main, args=(init,), nprocs=WORLD, join=True,
                           start_method="spawn")
    print("TORCH_DIST_SHARDED_CHECKS_OK")


if __name__ == "__main__":
    sys.exit(main())
