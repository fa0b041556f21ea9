"""The port's dry-run (`repro_torch.launch.dryrun`) and its census
(`repro_torch.launch.hlo_cost`) against the JAX package's.

The config arithmetic (`active_params`, `model_flops`) equals the
reference's exactly for every arch and shape.  The census counts the JAX
test programs of `tests/test_analysis.py` (a 7-layer loop, a nested 4 x 3
loop) within that test's 5% of the formula and of JAX's own census of the
same function, with the matmul FLOPs exact; and it is per device: on fake
process groups a matmul sharded over batch and model on 16x16 reads
exactly 2BKN/256 and a replicated one exactly 2BKN (the DTensor-level op
is not counted on top), and the all-reduce of a contracted-dimension
sharded f32 (64, 256) x (256, 64) over 4 ranks weighs 24,576 bytes.  The
bytes proxy skips views and counts an in-place slice update twice.  Two
cells of `tests/test_launch.py` run as subprocesses of the port's CLI.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.launch import dryrun as JD
from repro.launch.hlo_cost import analyze as j_analyze
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_shape
from repro_torch.core.shardmap_exec import world
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_cost import analyze

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ARCHS = [a for a in ARCH_IDS if a != "paper_rs"]


@pytest.fixture
def fake_group():
    def start(world_size):
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)
    try:
        yield start
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_arithmetic_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert D.active_params(cfg) == JD.active_params(jcfg)
    for name in SHAPES:
        assert D.model_flops(cfg, get_shape(name)) == JD.model_flops(
            jcfg, jget_shape(name)), name


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_census_of_a_layer_loop():
    """`test_hlo_census_scales_while_loops`' program: L x tanh(x @ w_i)."""
    n, d, L = 64, 128, 7

    def f(x, w):
        for i in range(L):
            x = torch.tanh(x @ w[i])
        return x

    def jf(x, w):
        def body(c, wi):
            return jnp.tanh(c @ wi), None
        return jax.lax.scan(body, x, w)[0]

    census = analyze(f, _meta(n, d), _meta(L, d, d))
    formula = L * 2 * n * d * d
    assert census["entry"] == "f"
    assert census["flops_by_op"]["aten.mm"] == formula
    assert abs(census["flops"] - formula) / formula < 0.05
    jc = j_analyze(jax.jit(jf).lower(
        jax.ShapeDtypeStruct((n, d), jnp.float32),
        jax.ShapeDtypeStruct((L, d, d), jnp.float32)).compile().as_text())
    assert abs(census["flops"] - jc["flops"]) / jc["flops"] < 0.05
    assert census["bytes"] > 0 and census["collective_bytes"] == 0


def test_census_of_a_nested_loop():
    """`test_hlo_census_nested_scan`'s program: 4 outer x 3 inner steps."""
    n, d, L = 32, 64, 4

    def f(x, w):
        for i in range(L):
            for _ in range(3):
                x = torch.tanh(x @ w[i])
        return x

    def jf(x, w):
        def outer(c, wi):
            def inner(ci, _):
                return jnp.tanh(ci @ wi), None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, w)[0]

    census = analyze(f, _meta(n, d), _meta(L, d, d))
    formula = L * 3 * 2 * n * d * d
    assert census["flops_by_op"]["aten.mm"] == formula
    assert abs(census["flops"] - formula) / formula < 0.05
    jc = j_analyze(jax.jit(jf).lower(
        jax.ShapeDtypeStruct((n, d), jnp.float32),
        jax.ShapeDtypeStruct((L, d, d), jnp.float32)).compile().as_text())
    assert abs(census["flops"] - jc["flops"]) / jc["flops"] < 0.05


def test_census_bytes_rules():
    """Output bytes of each op, none for views, 2 x the slice for an
    in-place slice update."""
    def f(buf, val):
        v = buf[:, 1:2]          # a view: no traffic
        v.copy_(val)             # 2 x val's bytes
        return (buf * 2.0).sum()  # buf's bytes, then one scalar's

    buf, val = _meta(8, 16), _meta(8, 1)
    r = analyze(f, buf, val)
    assert r["bytes"] == 2 * 8 * 4 + 8 * 16 * 4 + 4
    assert r["flops"] == 8 * 16 + 1  # the multiply a element, the sum one
    assert r["n_computations"] == 4  # slice, copy_, mul, sum


def _dtensor(mesh, shape, placements):
    from torch.distributed.tensor import DTensor

    local = list(shape)
    for mdim, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.shape[mdim]
    return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                              placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_census_weighs_an_all_reduce(fake_group):
    """`test_hlo_census_counts_collectives`: f32 (64, 64) all-reduced over 4
    ranks: 16384 bytes x 2 x 3/4."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    fake_group(4)
    mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("d",))
    x = _dtensor(mesh, (64, 256), [Shard(1)])
    w = _dtensor(mesh, (256, 64), [Shard(0)])

    def g(x, w):
        return (x @ w).redistribute(mesh, [Replicate()])

    r = analyze(g, x, w)
    assert r["collective_bytes"] == 24576
    assert r["collectives_by_kind"] == {
        "all-reduce": {"count": 1, "weighted_bytes": 24576.0}}
    assert r["flops_by_op"]["aten.mm"] == 2 * 64 * 64 * 64  # K/4 a rank


@pytest.mark.parametrize("sharded", [True, False])
def test_census_is_per_device(fake_group, sharded):
    """The double-counting trap: only the local op on this rank's shard
    counts, never the DTensor-level op at the global shape."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh

    fake_group(256)
    mesh = make_production_mesh()
    B, K, N = 256, 512, 1024
    xp = [Shard(0), Replicate()] if sharded else [Replicate(), Replicate()]
    wp = [Replicate(), Shard(1)] if sharded else [Replicate(), Replicate()]
    r = analyze(torch.matmul, _dtensor(mesh, (B, K), xp),
                _dtensor(mesh, (K, N), wp))
    want = 2 * B * K * N // (256 if sharded else 1)
    assert r["flops"] == r["flops_by_op"]["aten.mm"] == want
    assert r["collective_bytes"] == 0


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)


def _reference_keys() -> tuple[set, set, set]:
    """The keys of the JAX dry-run's result, its `memory` and its
    `roofline`, read from the source of `repro.launch.dryrun.run_cell`."""
    tree = ast.parse(Path(JD.__file__).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    result = next(n.value for n in ast.walk(fn)
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "result")
    terms = next(n.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "terms")

    def keys(d):
        return {k.value for k in d.keys if k is not None}

    inner = {k.value: v for k, v in zip(result.keys, result.values)
             if k is not None}
    return (keys(result), keys(inner["memory"]),
            keys(inner["roofline"]) | keys(terms))


@pytest.mark.parametrize("arch, shape, mesh, n", [
    ("qwen3_1_7b", "decode_32k", "single", 256),
    ("mamba2_780m", "long_500k", "multi", 512)])
def test_dryrun_cell_subprocess(tmp_path, arch, shape, mesh, n):
    proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                 shape, "--mesh", mesh, "--out-dir", str(tmp_path), "--force"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    cell = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
    assert "error" not in cell, cell.get("error")
    assert cell["n_devices"] == n
    assert cell["hlo_flops_per_device"] > 0
    assert cell["roofline"]["dominant"] in ("compute_s", "memory_s",
                                            "collective_s")
    assert cell["roofline_h100"]["dominant"] in ("compute_s", "memory_s",
                                                 "collective_s")
    top, memory, roofline = _reference_keys()
    assert set(cell) == top | {"roofline_h100", "no_torch_analog"}
    assert set(cell["memory"]) == memory
    assert set(cell["roofline"]) == set(cell["roofline_h100"]) == roofline
    for key in cell["no_torch_analog"]:
        node = cell
        for part in key.split("."):
            node = node[part]
        assert node is None, key
    assert cell["memory"]["argument_bytes"] > 0


def test_no_group_left_behind():
    assert not dist.is_initialized()
    assert world() == (1, 0)
