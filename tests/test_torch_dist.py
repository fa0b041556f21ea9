"""The port's sharding rules (`repro_torch.dist`) against the JAX package's.

The spec factories and `guard` are pure shape arithmetic, so their specs,
as tuples, are compared exactly with `repro.dist.sharding`'s on every
arch's full config, every applicable shape, and the axis sizes of the
production (16x16), multi-pod (2x16x16) and host (4x2) meshes; no JAX mesh
is needed.  `constrain` is checked on fake process groups (no device):
the placements it gives a DTensor are those the reference's spec names.
At smoke width, `forward`, `value_and_grad` and `decode_step` inside
`activation_sharding` equal the runs without it bitwise: with plain
tensors on a 1x1 fake mesh (`constrain` passes them through), and with the
parameters, optimizer state, batch and cache as DTensors placed by the
specs on a 1x1 gloo mesh of one rank (the card's `dist` phase on the CPU).
On 4 gloo ranks (a subprocess), the same runs with the specs' real
shardings on a 2x2 mesh agree with the plain ones within rtol 1e-4.
Every group is torn down in a fixture's `finally`; the last test checks
that none is left.
"""
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from conftest_hypothesis import given, settings, st
from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.data.pipeline import make_batch_specs as j_batch_specs
from repro.dist import ctx as jctx
from repro.dist import sharding as jshd
from repro.models import model as JM
from repro.train.state import abstract_state as j_abstract_state
from repro.train.state import make_train_setup as j_make_train_setup
from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.shardmap_exec import world
from repro_torch.data import make_batch_specs
from repro_torch.dist import ctx, sharding as shd
from repro_torch.dist import activation_sharding, constrain
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_axis_sizes)
from repro_torch.models import model as M
from repro_torch.models.convert import holding, to_reference
from repro_torch.train import (abstract_state, init_state, make_train_setup,
                               make_train_step)

torch.set_num_threads(1)

ARCHS = [a for a in ARCH_IDS if a != "paper_rs"]
MESHES = {"production": {"data": 16, "model": 16, "pod": 1},
          "multi_pod": {"pod": 2, "data": 16, "model": 16},
          "host": {"data": 4, "model": 2, "pod": 1}}
SIZES = [pytest.param(sizes, mp, id=f"{name}-{'mp' if mp else 'dp'}")
         for name, sizes in MESHES.items() for mp in (False, True)]


@pytest.fixture
def group():
    """`start(backend, world, rank)` initialises the default process group;
    it is destroyed when the test ends, however it ends."""
    def start(backend="fake", world_size=8, rank=0):
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            store = FakeStore()
        else:
            store = dist.HashStore()
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
    try:
        yield start
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tuples(specs) -> list:
    return [tuple(s) for s in tree_flatten(specs)[0]]


def _jtuples(specs) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


# ---------------------------------------------------------------------------
# guard and the logical names
# ---------------------------------------------------------------------------

def test_sharding_guard():
    """`tests/test_analysis.py::test_sharding_guard`'s four cases."""
    sizes = {"data": 16, "model": 16, "pod": 2}
    assert shd.guard(shd.PartitionSpec("model", None), (32, 7), sizes) == (
        "model", None)
    assert shd.guard(shd.PartitionSpec("model"), (30,), sizes) == (None,)
    assert shd.guard(shd.PartitionSpec(("pod", "data")), (64,), sizes) == (
        ("pod", "data"),)
    assert shd.guard(shd.PartitionSpec(("pod", "data")), (33,), sizes) == (
        None,)
    assert isinstance(shd.guard((), (), sizes), shd.PartitionSpec)


ENTRIES = [None, "data", "model", "pod", "x", ("pod", "data"),
           ("data", "model"), ("pod", "x")]


@settings(max_examples=300, deadline=None)
@given(entries=st.lists(st.sampled_from(ENTRIES), max_size=5),
       shape=st.lists(st.integers(1, 96), max_size=5),
       sizes=st.dictionaries(st.sampled_from(["data", "model", "pod"]),
                             st.integers(1, 16)))
def test_guard_matches_reference(entries, shape, sizes):
    want = jshd.guard(P(*entries), tuple(shape), sizes)
    assert tuple(shd.guard(shd.PartitionSpec(*entries), tuple(shape),
                           sizes)) == tuple(want)


@pytest.mark.parametrize("sizes", [{}, {"data": 4, "model": 2},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"pod": 2, "model": 16}])
def test_resolve_and_data_axes_match_reference(sizes):
    for name in [None, "batch", "data", "model", "pod", "x",
                 ("pod", "data"), ("x", "model"), ("x",)]:
        assert ctx._resolve(name, sizes) == jctx._resolve(name, sizes), name
    for mp in (False, True):
        assert shd.data_axes(sizes, mp) == jshd.data_axes(sizes, mp)


# ---------------------------------------------------------------------------
# the spec factories, every arch at its full config
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _states(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    state = abstract_state(cfg, make_train_setup(cfg)[0])
    jstate = j_abstract_state(jcfg, j_make_train_setup(jcfg)[0])
    shapes = [tuple(t.shape) for t in tree_flatten(state)[0]]
    assert shapes == [tuple(s.shape) for s in jax.tree.leaves(jstate)]
    return cfg, jcfg, state, jstate


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_reference(arch):
    cfg, jcfg, state, jstate = _states(arch)
    for p in SIZES:
        sizes, mp = p.values
        got = shd.param_specs(cfg, state.params, sizes, mp)
        want = jshd.param_specs(jcfg, jstate.params, sizes, mp)
        assert _tuples(got) == _jtuples(want)
        assert all(isinstance(s, shd.PartitionSpec)
                   for s in tree_flatten(got)[0])
        got = shd.opt_state_specs(cfg, state.params, state.opt_state, sizes, mp)
        want = jshd.opt_state_specs(jcfg, jstate.params, jstate.opt_state,
                                    sizes, mp)
        assert _tuples(got) == _jtuples(want)
    # a production mesh shards the big leaves over "model"
    specs = _tuples(shd.param_specs(cfg, state.params, MESHES["production"],
                                    False))
    assert any("model" in s for s in specs)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("sizes, multi_pod", SIZES)
def test_batch_and_cache_specs_match_reference(arch, sizes, multi_pod):
    cfg, jcfg = get_config(arch), jget(arch)
    for name, shape in SHAPES.items():
        if not cell_applicable(cfg, shape)[0]:
            continue
        jshape = jget_shape(name)
        got = shd.batch_specs(cfg, make_batch_specs(cfg, shape), sizes,
                              multi_pod)
        want = jshd.batch_specs(jcfg, j_batch_specs(jcfg, jshape), sizes,
                                multi_pod)
        assert sorted(got) == sorted(want)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}, name
        if shape.kind != "decode":
            continue
        B, S = shape.global_batch, shape.seq_len
        cache = M.init_cache(cfg, B, S, device="meta")
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S))
        got = shd.cache_specs(cfg, cache, sizes, multi_pod)
        want = jshd.cache_specs(jcfg, jcache, sizes, multi_pod)
        assert _tuples(got) == _jtuples(want), name


# ---------------------------------------------------------------------------
# placements and constrain on fake groups
# ---------------------------------------------------------------------------

def test_constrain_is_the_identity_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert ctx.current_mesh() is None
    assert constrain(x, "batch", "model") is x


def _meta_dtensor(shape, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def _expected(spec, mesh):
    """The placements a JAX spec names, spelled out: Shard(d) on each mesh
    dimension entry d names."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


CASES = [((8, 6, 10), ("batch", None, "model")),
         ((6, 6, 10), ("batch", None, "model")),   # 6 % 4: batch dropped
         ((8, 4, 2, 3), ("batch", "model", None, None)),
         ((8, 5), (None, "model")),                 # 5 % 2: dropped
         ((8, 6), ("x", "data"))]                   # unknown axis; 6 % 4


@pytest.mark.parametrize("shape, axes", CASES)
def test_constrain_on_the_host_mesh_matches_reference(group, shape, axes):
    group("fake", 8)
    mesh = make_host_mesh()
    assert mesh.device_type == "cuda" and mesh_axis_sizes(mesh) == {
        "data": 4, "model": 2, "pod": 1}
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    want = jshd.guard(P(*(jctx._resolve(a, sizes) for a in axes)), shape,
                      sizes)
    x = _meta_dtensor(shape, mesh)
    with activation_sharding(mesh):
        assert ctx.current_mesh() is mesh
        y = constrain(x, *axes)
    assert ctx.current_mesh() is None
    assert tuple(y.placements) == _expected(want, mesh)
    assert tuple(y.shape) == shape
    assert tuple(y.to_local().shape) == shd.local_shape(shape, want, mesh)
    plain = torch.empty(shape, device="meta")
    with activation_sharding(mesh):
        assert constrain(plain, *axes) is plain


@pytest.mark.parametrize("multi_pod", [False, True])
def test_constrain_batch_takes_the_pod_axis_when_asked(group, multi_pod):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    group("fake", 8)
    mesh = init_device_mesh("cuda", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    with activation_sharding(mesh, multi_pod):
        y = constrain(_meta_dtensor((8, 3, 4), mesh), "batch", None, "model")
    pod = Shard(0) if multi_pod else Replicate()
    assert tuple(y.placements) == (pod, Shard(0), Shard(2))


@pytest.mark.parametrize("rank", [0, 3, 5, 7])
def test_two_axis_shards_are_pod_major(group, rank):
    """("pod", "data") on one dimension: the rank at (pod p, data d) holds
    block p * |data| + d, as in JAX."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    from torch.distributed.device_mesh import init_device_mesh

    group("fake", 8, rank)
    mesh = init_device_mesh("cuda", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    spec = shd.PartitionSpec(("pod", "data"), "model")
    local, offset = compute_local_shape_and_global_offset(
        (16, 6), mesh, shd.placements(spec, mesh))
    p, d, m = mesh.get_coordinate()
    assert tuple(local) == shd.local_shape((16, 6), spec, mesh) == (4, 3)
    assert tuple(offset) == ((p * 2 + d) * 4, m * 3)
    with pytest.raises(ValueError, match="axis order"):
        shd.placements(shd.PartitionSpec(("data", "pod")), mesh)


def test_production_meshes(group):
    group("fake", 256)
    mesh = make_production_mesh()
    assert mesh.mesh_dim_names == ("data", "model") and mesh.size() == 256
    assert mesh_axis_sizes(mesh) == {"data": 16, "model": 16, "pod": 1}
    dist.destroy_process_group()
    group("fake", 512)
    mesh = make_production_mesh(multi_pod=True)
    assert mesh_axis_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("heads, kept", [(4, True), (5, False)])
def test_split_heads_gathers_what_the_heads_cannot_divide(group, heads,
                                                          kept):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.ctx import split_heads

    group("fake", 8)
    mesh = make_host_mesh()
    x = shd.from_local(torch.empty((1, 3, heads * 4 // 2), device="meta"),
                       shd.PartitionSpec("data", None, "model"), mesh)
    assert tuple(x.shape) == (4, 3, heads * 4)
    with activation_sharding(mesh):
        y = split_heads(x, (4, 3, heads, 4))
    assert tuple(y.shape) == (4, 3, heads, 4)
    assert tuple(y.placements) == (Shard(0), Shard(2) if kept else Replicate())
    assert split_heads(torch.zeros(2, 3, 8), (2, 3, 2, 4)).shape == (2, 3, 2, 4)


def test_bind_gathers_a_layer_axis_sharded_stack(group):
    """A spec may put "model" on a stacked leaf's layer axis (hymba's
    (32, 50) leaves on 16 ranks); the per-layer views gather it."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.convert import _whole_layer_axis

    group("fake", 8)
    mesh = make_host_mesh()
    x = shd.from_local(torch.empty((2, 5), device="meta"),
                       shd.PartitionSpec("model", None), mesh)
    layers = torch.unbind(_whole_layer_axis(x), 0)
    assert len(layers) == 4 and tuple(layers[0].shape) == (5,)
    assert all(p == Replicate() for p in layers[0].placements)


# ---------------------------------------------------------------------------
# bitwise at smoke width
# ---------------------------------------------------------------------------

def _inputs(cfg, B=2, S=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                dtype=np.float32))
    enc = None
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model), dtype=np.float32))
        enc = batch["frames"].to(torch.bfloat16)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, B)))
    return batch, enc, tokens


def _decode(cfg, model, tokens, cache, enc, wrap=lambda t: t):
    outs = []
    for i, tok in enumerate(tokens):
        logits, cache = M.decode_step(cfg, model, wrap(tok), i, cache, enc)
        outs.append(logits)
    return outs


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _equal(a, b) -> bool:
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(_local(x), _local(y)) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_mesh_scope_is_bitwise(group, arch):
    """Plain tensors inside `activation_sharding` of a 1x1 fake mesh."""
    cfg = get_config(arch).smoke()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = to_reference(model)
    batch, enc, tokens = _inputs(cfg)

    def run():
        logits = M.forward(cfg, params, batch)
        loss, grads = M.value_and_grad(cfg, params, batch)
        cache = M.init_cache(cfg, 2, 8, device="cpu")
        return logits, loss, grads, _decode(cfg, model, tokens, cache, enc)

    want = run()
    group("fake", 1)
    mesh = make_host_mesh(1, 1)
    with activation_sharding(mesh):
        got = run()
    assert _equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_step_and_decode_are_bitwise(group, arch):
    """The state, batch and cache as DTensors placed by the specs on a 1x1
    gloo mesh (one rank): one train step and 4 decode steps equal the
    plain ones bitwise."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(arch).smoke()
    opt, _ = make_train_setup(cfg)
    state = init_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")
    batch, enc, tokens = _inputs(cfg)
    step = make_train_step(cfg, opt)
    want_state, want_m = step(state, batch)
    model = holding(cfg, state.params)
    want_dec = _decode(cfg, model, tokens, M.init_cache(cfg, 2, 8, device="cpu"),
                       enc)

    group("gloo", 1)
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    sizes = mesh_axis_sizes(mesh)
    sspec = type(state)(shd.PartitionSpec(),
                        shd.param_specs(cfg, state.params, sizes, False),
                        shd.opt_state_specs(cfg, state.params, state.opt_state,
                                            sizes, False))
    dstate = shd.from_local(state, sspec, mesh)
    dbatch = shd.from_local(batch, shd.batch_specs(cfg, batch, sizes, False),
                            mesh)
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    dcache = shd.from_local(cache, shd.cache_specs(cfg, cache, sizes, False),
                            mesh)
    denc = None if enc is None else shd.from_local(
        enc, shd.batch_specs(cfg, enc, sizes, False), mesh)
    tspec = shd.batch_specs(cfg, tokens[0], sizes, False)
    with activation_sharding(mesh), implicit_replication():
        got_state, got_m = step(dstate, dbatch)
        got_dec = _decode(cfg, holding(cfg, dstate.params), tokens, dcache,
                          denc, lambda t: shd.from_local(t, tspec, mesh))
    assert isinstance(got_m["loss"], DTensor)
    assert isinstance(tree_flatten(got_state.params)[0][0], DTensor)
    assert _equal(got_state, want_state) and _equal(got_m, want_m)
    assert _equal(got_dec, want_dec)


def test_sharded_model_across_gloo_ranks_matches_plain():
    """`tests/torch_dist_sharded_checks.py`: 4 gloo ranks, a 2x2 mesh, the
    specs' real shardings; loss, gradients and decode logits within
    rtol 1e-4 of the plain run for a dense, a MoE and an SSM arch."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    proc = subprocess.run(
        [sys.executable, str(repo / "tests" / "torch_dist_sharded_checks.py")],
        capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    for arch in ("qwen3_1_7b", "phi3_5_moe_42b_a6_6b", "mamba2_780m"):
        assert f"{arch}: loss, grads, decode within rtol" in proc.stdout
    assert "TORCH_DIST_SHARDED_CHECKS_OK" in proc.stdout


def test_no_group_left_behind():
    """Every test above tore its group down: the mesh backend's world is
    one rank again."""
    assert not dist.is_initialized()
    assert world() == (1, 0)
