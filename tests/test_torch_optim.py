"""The port's optimizers, schedules, data pipeline and int8 gradient
compression (`repro_torch.optim`, `repro_torch.data`,
`repro_torch.train.train_loop._int8_compress_decompress`) against the JAX
package's on the CPU.

One optimizer update on the same numpy params, grads and state gives
JAX's params and state within atol 1e-6 / rtol 1e-5 (float32, two
frameworks: the sums run in other orders); the state's leaf shapes are
JAX's.  The schedules agree at every integer step within 1e-6 relative.
`host_batch` and the int8 compression are bitwise JAX's.  Within the
port, JAX's own optimizer and schedule scenarios
(`tests/test_substrate.py`) hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_batch_specs as j_make_batch_specs
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import cosine_schedule as j_cosine
from repro.optim import make_schedule as j_make_schedule
from repro.optim import wsd_schedule as j_wsd
from repro.train.train_loop import _int8_compress_decompress as j_int8
from repro_torch.configs import ARCH_IDS, cell_applicable, get_config, get_shape
from repro_torch.core.pytree import tree_flatten, tree_map
from repro_torch.data import SyntheticLM, make_batch_specs
from repro_torch.models.config import SHAPES
from repro_torch.optim import (
    adafactor,
    adamw,
    cosine_schedule,
    make_optimizer,
    make_schedule,
    wsd_schedule,
)
from repro_torch.optim.optimizers import clip_by_global_norm, global_norm
from repro_torch.train.train_loop import _int8_compress_decompress

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5
ARCHS = [a for a in ARCH_IDS if a != "paper_rs"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return tree_map(lambda x: np.asarray(x), tree)


def _problem(seed):
    """Params, and grads with a zero leaf, a tiny leaf and a leaf of mixed
    magnitudes; a stacked (L, D) leaf and a (L, D, F) one."""
    rng = np.random.default_rng(seed)
    f = np.float32
    params = {"w": rng.standard_normal((6, 5)).astype(f),
              "stack": rng.standard_normal((3, 8)).astype(f),
              "cube": rng.standard_normal((2, 4, 3)).astype(f),
              "b": rng.standard_normal(7).astype(f),
              "s": np.asarray(rng.standard_normal(), f)}
    grads = {"w": rng.standard_normal((6, 5)).astype(f),
             "stack": (rng.standard_normal((3, 8)) * 1e-20).astype(f),
             "cube": np.zeros((2, 4, 3), f),
             "b": (rng.standard_normal(7) * np.array([1e3, 1, 1e-3, 1e-7, 0,
                                                      5, -2])).astype(f),
             "s": np.asarray(0.25, f)}
    return params, grads


def _leaf_shapes(tree):
    return [tuple(np.shape(x)) for x in tree_flatten(_np_tree(tree))[0]]


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_update_matches_reference(kind):
    jopt = {"adamw": j_adamw, "adafactor": j_adafactor}[kind](lambda s: 0.01)
    topt = make_optimizer(kind, lambda s: 0.01)
    params, _ = _problem(0)
    jp, tp = params, tree_map(_t, params)
    js, ts = jopt.init(jax.tree.map(jnp.asarray, jp)), topt.init(tp)
    assert _leaf_shapes(ts) == _leaf_shapes(js)
    for step in range(3):
        _, grads = _problem(step + 1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js,
                             jax.tree.map(jnp.asarray, jp), jnp.int32(step))
        tp, ts = topt.update(tree_map(_t, grads), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
        for got, want in zip(tree_flatten(_np_tree((tp, ts)))[0],
                             tree_flatten(_np_tree((jp, js)))[0]):
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        jp = _np_tree(jp)
    assert _leaf_shapes(ts) == _leaf_shapes(js)


def test_update_leaves_its_arguments_unchanged():
    params, grads = _problem(3)
    tp, tg = tree_map(_t, params), tree_map(_t, grads)
    for opt in (adamw(lambda s: 0.1), adafactor(lambda s: 0.1)):
        st = opt.init(tp)
        before = [x.clone() for x in tree_flatten((tp, tg, st))[0]]
        opt.update(tg, st, tp, 0)
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_flatten((tp, tg, st))[0]))


def test_global_norm_and_clip_match_reference():
    from repro.optim.optimizers import clip_by_global_norm as j_clip

    _, grads = _problem(4)
    jc, jn = j_clip(jax.tree.map(jnp.asarray, grads), 1.0)
    tc, tn = clip_by_global_norm(tree_map(_t, grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    assert float(global_norm(tree_map(_t, grads))) == float(tn)
    for got, want in zip(tree_flatten(_np_tree(tc))[0],
                         tree_flatten(_np_tree(jc))[0]):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ---------------- JAX's scenarios within the port ---------------------------

def _quad_problem():
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor(4.0)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    def grad(p):
        xs = {k: v.detach().requires_grad_() for k, v in p.items()}
        gs = torch.autograd.grad(loss(xs), list(xs.values()))
        return dict(zip(xs, gs))

    return params, loss, grad


@pytest.mark.parametrize("make", [
    lambda: adamw(lambda s: 0.1, weight_decay=0.0),
    lambda: adafactor(lambda s: 0.5),
])
def test_optimizers_converge_quadratic(make):
    opt = make()
    params, loss, grad = _quad_problem()
    state = opt.init(params)
    l0 = float(loss(params))
    for i in range(200):
        params, state = opt.update(grad(params), state, params,
                                   torch.tensor(i, dtype=torch.int32))
    assert float(loss(params)) < 1e-2 * l0


def test_adafactor_state_is_factored():
    opt = adafactor(lambda s: 0.1)
    params = {"w": torch.zeros((64, 32)), "b": torch.zeros(7)}
    st_ = opt.init(params)
    assert st_["w"]["r"].shape == (64,) and st_["w"]["c"].shape == (32,)
    assert st_["b"]["v"].shape == (7,)
    # factored state is ~(64+32)/(64*32) of adamw's per-element state
    adam_state = adamw(lambda s: 0.1).init(params)
    fac = sum(x.numel() for x in tree_flatten(st_)[0])
    full = sum(x.numel() for x in tree_flatten(adam_state)[0])
    assert fac < full / 10


def test_schedules():
    cos = cosine_schedule(1.0, warmup=10, total=110)
    assert float(cos(0)) == 0.0
    assert abs(float(cos(10)) - 1.0) < 1e-6
    assert float(cos(110)) < 0.2
    wsd = wsd_schedule(1.0, warmup=10, stable=80, decay=20)
    assert abs(float(wsd(50)) - 1.0) < 1e-6  # stable region
    assert float(wsd(109)) < 0.2             # decayed
    assert float(wsd(5)) == 0.5              # warmup
    assert cos(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("name,port,ref", [
    ("cosine", lambda: cosine_schedule(3e-3, 10, 100),
     lambda: j_cosine(3e-3, 10, 100)),
    ("cosine floor", lambda: cosine_schedule(1.0, 0, 37, floor=0.3),
     lambda: j_cosine(1.0, 0, 37, floor=0.3)),
    ("wsd", lambda: wsd_schedule(5e-3, 10, 72, 18),
     lambda: j_wsd(5e-3, 10, 72, 18)),
    ("make wsd", lambda: make_schedule("wsd", 1e-2, 250),
     lambda: j_make_schedule("wsd", 1e-2, 250)),
    ("make cosine", lambda: make_schedule("cosine", 3e-4, 1000, warmup=3),
     lambda: j_make_schedule("cosine", 3e-4, 1000, warmup=3)),
])
def test_schedules_match_reference_at_every_step(name, port, ref):
    lp, lj = port(), ref()
    steps = np.arange(0, 260)
    got = np.array([float(lp(int(s))) for s in steps])
    want = np.asarray(jax.vmap(lj)(jnp.asarray(steps, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------- data ------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 16, 8, 0),
                                                  (151936, 33, 6, 3),
                                                  (256, 64, 4, 11)])
def test_host_batch_is_the_reference_bitwise(vocab, seq, batch, seed):
    j = JSyntheticLM(vocab, seq, batch, seed)
    t = SyntheticLM(vocab, seq, batch, seed)
    for step, shard, n_shards in [(0, 0, 1), (3, 0, 2), (3, 1, 2),
                                  (17, 2, 3), (1000, 0, 1)]:
        if batch % n_shards:
            continue
        got, want = t.host_batch(step, shard, n_shards), j.host_batch(
            step, shard, n_shards)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert np.array_equal(got[k], want[k])
    db = t.device_batch(5, "cpu")
    for k, v in j.device_batch(5).items():
        assert db[k].dtype == torch.int64
        assert np.array_equal(db[k].numpy(), np.asarray(v))


def test_synthetic_data_deterministic_and_sharded():
    d = SyntheticLM(vocab=1000, seq_len=16, global_batch=8)
    b1 = d.host_batch(step=3, shard=0, n_shards=2)
    b2 = d.host_batch(step=3, shard=0, n_shards=2)
    b3 = d.host_batch(step=3, shard=1, n_shards=2)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == (4, 16)
    assert np.array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_device_batch_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(100, 4, 2).device_batch(0)


_DTYPES = {"int32": torch.int64, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_reference(arch):
    for shape in SHAPES:
        cfg, sh = get_config(arch), get_shape(shape)
        if not cell_applicable(cfg, sh)[0]:
            continue
        want = j_make_batch_specs(jget(arch), jget_shape(shape))
        got = make_batch_specs(cfg, sh)
        assert got.keys() == want.keys()
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(spec.shape)
            assert got[k].dtype == _DTYPES[str(spec.dtype)]


# ---------------- int8 gradient compression ----------------------------------

def _compress_cases():
    rng = np.random.default_rng(7)
    g = rng.standard_normal((33, 17)).astype(np.float32)
    g[0, :3] = [-1.5, 2.5, 1e-9]
    ties = (np.arange(-300, 301, dtype=np.float32) / 2.0)  # x.5 everywhere
    return [("float32", g), ("float32 ties", ties),
            ("float32 zeros", np.zeros((5, 3), np.float32)),
            ("float32 tiny", np.full(9, 3e-10, np.float32)),
            ("bfloat16", g), ("bfloat16 ties", ties),
            ("bfloat16 zeros", np.zeros((4, 4), np.float32))]


@pytest.mark.parametrize("name,g", _compress_cases(),
                         ids=[c[0] for c in _compress_cases()])
def test_int8_compression_is_the_reference_bitwise(name, g):
    if name.startswith("bfloat16"):
        jg = jnp.asarray(g, jnp.bfloat16)
        tg = torch.from_numpy(g).to(torch.bfloat16)
        assert np.array_equal(tg.view(torch.int16).numpy(),
                              np.asarray(jg).view(np.int16))
    else:
        jg, tg = jnp.asarray(g), torch.from_numpy(g)
    want = np.asarray(j_int8(jg))
    got = _int8_compress_decompress(tg)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
