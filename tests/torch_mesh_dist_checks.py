"""The port's mesh backend across G gloo ranks on the CPU (run by
`test_torch_mesh_dist.py` in a subprocess; not collected by pytest).

The parent computes every scenario's output twice — on the port's mesh with
one rank (G = 1) and on the JAX package's simulator — and requires them
equal.  It then spawns G in {2, 4, 8} ranks of a gloo process group
(rendezvous through a file in a fresh temporary directory, so concurrent
runs never share a port); every rank runs every scenario SPMD (the same
entry point, the same payload) and must return the G = 1 output bitwise,
with legs across ranks.  K % G != 0 must fail at plan time.

    PYTHONPATH=src python tests/torch_mesh_dist_checks.py

Prints 'TORCH_MESH_DIST_CHECKS_OK' on success; any failure is fatal.
"""
import os
import sys
import tempfile

import numpy as np

GS = (2, 4, 8)
Q = 65537
CPU = "cpu"


def _payload(K, W, seed):
    return np.random.default_rng(seed).integers(0, Q, (K, W), dtype=np.int64)


def scenarios():
    """name -> (run on the port, run on the reference simulator); each
    returns a numpy array and the port's run also the mesh objects it
    used (their legs are counted)."""
    def encode(kind, K, R, method="auto", topo=None, commute=False, seed=0):
        x = _payload(K, 40, seed)

        def port():
            from repro_torch.api import CodeSpec, Encoder, Topology
            from repro_torch.topo import place

            spec = CodeSpec(kind=kind, K=K, R=R)
            pl = place(spec, Topology(*topo), "affinity") if topo else None
            plan = Encoder.plan(spec, backend="mesh", method=method,
                                topology=pl, commute=commute, device=CPU)
            y = plan.run(x)
            if not commute:  # the stream takes each rank's block too
                s = np.concatenate(list(plan.run_stream(x, chunk_w=16)), 1)
                assert np.array_equal(s, y), (kind, K, R, "stream")
            return y, [plan.mesh_callable().mesh]

        def ref():
            from repro.api import CodeSpec, Encoder, Topology
            from repro.topo import place

            spec = CodeSpec(kind=kind, K=K, R=R)
            pl = place(spec, Topology(*topo), "affinity") if topo else None
            return Encoder.plan(spec, backend="simulator", method=method,
                                topology=pl, commute=commute).run(x)
        return port, ref

    def decode(kind, K, R, erased, seed=5):
        x = _payload(K, 40, seed)

        def port():
            from repro_torch.api import CodeSpec, Encoder
            from repro_torch.recover import Decoder
            from repro_torch.recover.backends import _mesh_callables

            spec = CodeSpec(kind=kind, K=K, R=R)
            cw = np.concatenate([x, Encoder.plan(spec, backend="mesh",
                                                 device=CPU).run(x)])
            plan = Decoder.plan(spec, erased=erased, backend="mesh",
                                device=CPU)
            y = plan.run(cw[list(plan.kept)])
            assert np.array_equal(y, cw[list(erased)]), (kind, erased)
            return y, [f.mesh for f in _mesh_callables(plan)]

        def ref():
            from repro.api import CodeSpec, Encoder
            from repro.recover import Decoder

            spec = CodeSpec(kind=kind, K=K, R=R)
            cw = np.concatenate([x, Encoder.plan(spec,
                                                 backend="simulator").run(x)])
            plan = Decoder.plan(spec, erased=erased, backend="simulator")
            return plan.run(cw[list(plan.kept)])
        return port, ref

    return {
        "rs 8/4 universal": encode("rs", 8, 4, "universal", seed=1),
        "rs 8/4 rs": encode("rs", 8, 4, "rs", seed=2),
        "dft 8/8": encode("dft", 8, 8, seed=3),
        "rs 8/4 decode of 3": decode("rs", 8, 4, (1, 6, 10)),
        "rs 16/4 commuted": encode("rs", 16, 4, topo=(5, 4), commute=True,
                                   seed=4),
    }


def worker(rank, G, tmp):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{G}",
                            rank=rank, world_size=G)
    try:
        refs = np.load(os.path.join(tmp, "refs.npz"))
        for i, (name, (port, _)) in enumerate(scenarios().items()):
            y, meshes = port()
            assert np.array_equal(y, refs[f"s{i}"]), (G, rank, name)
            assert all(m.G == G and m.rank == rank for m in meshes)
            assert sum(m.cross_rank for m in meshes) > 0, (G, name)
        from repro_torch.api import BackendCapabilityError, CodeSpec, Encoder

        try:
            Encoder.plan(CodeSpec(kind="rs", K=9, R=3), backend="mesh",
                         device=CPU)
        except BackendCapabilityError as exc:
            assert "ranks" in str(exc), exc
        else:
            raise AssertionError(f"K=9 on G={G} ranks must fail at plan time")
        if rank == 0:
            print(f"G={G}: every rank bitwise == G=1 == simulator, with "
                  "legs across ranks", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch
    import torch.multiprocessing as mp

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        refs = {}
        for i, (name, (port, ref)) in enumerate(scenarios().items()):
            y, meshes = port()
            assert all(m.G == 1 for m in meshes)
            assert np.array_equal(y, ref()), name
            refs[f"s{i}"] = y
        np.savez(os.path.join(tmp, "refs.npz"), **refs)
        print(f"G=1: {len(refs)} scenarios bitwise == simulator", flush=True)
        for G in GS:
            mp.spawn(worker, args=(G, tmp), nprocs=G, join=True)
    print("TORCH_MESH_DIST_CHECKS_OK")


if __name__ == "__main__":
    sys.exit(main())
