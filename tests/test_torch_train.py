"""The port's training substrate (`repro_torch.models.model.value_and_grad`,
`repro_torch.train.state`, `repro_torch.train.train_loop`) against the JAX
package's on the CPU, on JAX's seeded weights and state carried across as
numpy.

Float32 smoke configs of all 10 archs: the loss within atol 2e-4 of
`jax.value_and_grad`'s and every leaf's gradient within
||g_port - g_jax|| <= 1e-4 ||g_jax|| + 1e-6 (two frameworks sum in other
orders).  `make_train_step` with adamw and adafactor, microbatched or
not, over three steps: loss and grad norm within rtol 1e-4, params and
optimizer state within atol 1e-4 / rtol 1e-3.  Remat changes no bit.  The
state's layout round-trips bitwise, and a checkpoint of the same state
is JAX's byte for byte, in both directions.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CodedCheckpointer as JCkpt
from repro.configs import get_config as jget
from repro.models import model as JM
from repro.train import init_state as j_init_state
from repro.train import make_train_setup as j_make_train_setup
from repro.train import make_train_step as j_make_train_step
from repro_torch.ckpt import CodedCheckpointer as TCkpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.pytree import tree_flatten, tree_map
from repro_torch.models import model as M
from repro_torch.models.convert import _as_tensor, from_reference, to_reference
from repro_torch.optim import make_optimizer
from repro_torch.train import (
    TrainState,
    abstract_state,
    init_state,
    make_eval_step,
    make_train_setup,
    make_train_step,
)
from repro_torch.train.state import (
    from_reference_state,
    state_to,
    to_reference_state,
)

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ARCHS = [a for a in ARCH_IDS if a != "paper_rs"]
LOSS_ATOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6          # on each leaf's 2-norm
STEP_RTOL = 1e-4                           # loss and grad norm of a step
STATE_ATOL, STATE_RTOL = 1e-4, 1e-3        # params and optimizer state


def _f32(arch, **kw):
    return (dataclasses.replace(get_config(arch).smoke(), dtype="float32", **kw),
            dataclasses.replace(jget(arch).smoke(), dtype="float32", **kw))


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        arrays["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32
          else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, tb


def _leaves_np(tree):
    return [np.asarray(x) for x in tree_flatten(tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, tree))[0]]


def _assert_grads_close(tg, jg):
    got, want = _leaves_np(tg), _leaves_np(jax.device_get(jg))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        err = np.linalg.norm(a.astype(np.float64) - b)
        assert err <= GRAD_RTOL * np.linalg.norm(b) + GRAD_ATOL, (i, err)


# ---------------- loss and gradients -----------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_value_and_grad_matches_reference(arch):
    cfg, jcfg = _f32(arch)
    jp = jax.device_get(JM.init_params(jcfg, KEY))
    jb, tb = _batch(cfg)
    jl, jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, jb))(jp)
    tree = tree_map(_as_tensor, jp)
    tl, tg = M.value_and_grad(cfg, tree, tb)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    _assert_grads_close(tg, jg)
    # the model on the tree is the model on its `Model`: same loss
    with torch.no_grad():
        assert torch.equal(M.loss_fn(cfg, from_reference(cfg, jp, "cpu"), tb),
                           M.loss_fn(cfg, tree, tb))


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "phi3_5_moe_42b_a6_6b",
                                  "mamba2_780m", "hymba_1_5b",
                                  "whisper_large_v3", "llava_next_mistral_7b"])
def test_remat_changes_no_bit(arch):
    cfg = get_config(arch).smoke()  # bf16, remat off
    tree = to_reference(M.init_params(cfg, torch.Generator().manual_seed(1),
                                      "cpu"))
    _, tb = _batch(cfg, seed=2)
    rcfg = dataclasses.replace(cfg, remat=True)
    l0, g0 = M.value_and_grad(cfg, tree, tb)
    l1, g1 = M.value_and_grad(rcfg, tree, tb)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(g0)[0],
                                                 tree_flatten(g1)[0]))


def test_value_and_grad_reads_its_params_and_zero_fills_unused():
    cfg = get_config("llava_next_mistral_7b").smoke()
    tree = to_reference(M.init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"))
    _, tb = _batch(cfg)
    del tb["vision_embeds"]  # vis_proj is then not reached, as in JAX
    before = [t.clone() for t in tree_flatten(tree)[0]]
    loss, grads = M.value_and_grad(cfg, tree, tb)
    assert all(torch.equal(a, b) and not b.requires_grad
               for a, b in zip(before, tree_flatten(tree)[0]))
    assert not loss.requires_grad
    assert torch.count_nonzero(grads["vis_proj"]) == 0
    assert grads["vis_proj"].dtype == tree["vis_proj"].dtype
    assert torch.count_nonzero(grads["embed"]) > 0


def test_model_params_take_no_gradient_and_prefill_builds_no_graph():
    from repro_torch.train.serve import make_prefill_step

    cfg = get_config("qwen3_1_7b").smoke()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(cfg)
    assert not any(p.requires_grad for p in model.parameters())
    assert not make_prefill_step(cfg)(model, tb).requires_grad
    assert not make_eval_step(cfg)(to_reference(model), tb).requires_grad


# ---------------- the train step ----------------------------------------------

def _carried_state(jcfg, cfg, kind):
    jopt, _ = j_make_train_setup(jcfg, total_steps=20, peak_lr=5e-3)
    opt, _ = make_train_setup(cfg, total_steps=20, peak_lr=5e-3)
    assert (jcfg.optimizer, cfg.optimizer) == (kind, kind)
    js = jax.device_get(j_init_state(jcfg, KEY, jopt))
    return jopt, opt, js, from_reference_state(js, "cpu")


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(kind, microbatches):
    cfg, jcfg = _f32("qwen3_1_7b", optimizer=kind)
    jopt, opt, js, ts = _carried_state(jcfg, cfg, kind)
    jstep = jax.jit(j_make_train_step(jcfg, jopt, microbatches))
    tstep = make_train_step(cfg, opt, microbatches)
    for i in range(3):
        jb, tb = _batch(cfg, B=4, S=16, seed=10 + i)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=STEP_RTOL)
        assert int(tm["lr_step"]) == int(jm["lr_step"]) == i
    js = jax.device_get(js)
    assert int(ts.step) == int(js.step) == 3
    got, want = _leaves_np((ts.params, ts.opt_state)), _leaves_np(
        (js.params, js.opt_state))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=STATE_ATOL, rtol=STATE_RTOL)


def test_train_step_leaves_its_state_unchanged():
    cfg = get_config("qwen3_1_7b").smoke()
    opt, _ = make_train_setup(cfg, total_steps=10, peak_lr=5e-3)
    state = init_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")
    _, tb = _batch(cfg)
    before = [t.clone() for t in tree_flatten(state)[0]]
    s1, _ = make_train_step(cfg, opt)(state, tb)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_flatten(state)[0]))
    s2, _ = make_train_step(cfg, opt)(state, tb)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(s1)[0],
                                                 tree_flatten(s2)[0]))


@pytest.mark.parametrize("coded", [False, True])
def test_step_output_is_freed_when_dropped(coded):
    """No reference cycle holds a step's new state (tree walkers once kept
    every leaf alive through their own closures until a collection)."""
    import gc
    import weakref

    from repro_torch.coding import GradientCoder
    from repro_torch.data import SyntheticLM
    from repro_torch.train import make_straggler_train_step

    cfg = dataclasses.replace(get_config("qwen3_1_7b").smoke(), remat=True)
    opt, _ = make_train_setup(cfg, total_steps=10, peak_lr=5e-3)
    state = init_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")
    batch = SyntheticLM(cfg.vocab, 16, 4).device_batch(0, "cpu")
    step = (make_straggler_train_step(cfg, opt, GradientCoder(4, s=1))
            if coded else make_train_step(cfg, opt))
    step(state, batch)  # the first call imports what remat needs
    gc.disable()
    try:
        new, _ = step(state, batch)
        refs = [weakref.ref(t) for t in tree_flatten(new)[0]]
        del new
        assert sum(r() is not None for r in refs) == 0
    finally:
        gc.enable()


def test_compressed_train_step_matches_reference():
    cfg, jcfg = _f32("qwen3_1_7b")
    jopt, opt, js, ts = _carried_state(jcfg, cfg, "adamw")
    jb, tb = _batch(cfg, B=4, S=16, seed=3)
    js, jm = jax.jit(j_make_train_step(jcfg, jopt, compress_grads=True))(js, jb)
    ts, tm = make_train_step(cfg, opt, compress_grads=True)(ts, tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_RTOL)
    for a, b in zip(_leaves_np(ts.params), _leaves_np(jax.device_get(js.params))):
        np.testing.assert_allclose(a, b, atol=STATE_ATOL, rtol=STATE_RTOL)


# ---------------- state layout --------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_1_7b", "kimi_k2_1t_a32b",
                                  "hymba_1_5b"])
def test_state_round_trips_bitwise_and_has_the_reference_layout(arch):
    jcfg, cfg = jget(arch).smoke(), get_config(arch).smoke()
    jopt, _ = j_make_train_setup(jcfg)
    opt, _ = make_train_setup(cfg)
    js = jax.device_get(j_init_state(jcfg, KEY, jopt))
    ts = from_reference_state(js, "cpu")
    assert isinstance(ts, TrainState) and ts.step.dtype == torch.int32
    back = to_reference_state(ts)
    jl, jdef = jax.tree.flatten(js)
    bl, _ = jax.tree.flatten(back)
    assert len(bl) == len(jl)
    for a, b in zip(bl, jl):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the port's own init: same leaves, shapes and dtypes as JAX's
    mine = init_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")
    meta = abstract_state(cfg, opt)
    ml = tree_flatten(mine)[0]
    al = tree_flatten(meta)[0]
    assert len(ml) == len(al) == len(jl)
    for a, m, j in zip(ml, al, jl):
        assert m.device.type == "meta"
        assert tuple(a.shape) == tuple(m.shape) == tuple(j.shape)
        assert a.dtype == m.dtype
        assert str(a.dtype).replace("torch.", "") == str(j.dtype)


def test_init_state_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3_1_7b").smoke()
    opt, _ = make_train_setup(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_state(cfg, None, opt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_reference_state(jax.device_get(
            j_init_state(jget("qwen3_1_7b").smoke(), KEY,
                         j_make_train_setup(jget("qwen3_1_7b").smoke())[0])))


def test_adafactor_state_of_stacked_leaves_is_the_reference_shape():
    cfg = dataclasses.replace(get_config("qwen3_1_7b").smoke(),
                              optimizer="adafactor")
    jcfg = dataclasses.replace(jget("qwen3_1_7b").smoke(), optimizer="adafactor")
    jopt, _ = j_make_train_setup(jcfg)
    js = jax.eval_shape(lambda: j_init_state(jcfg, KEY, jopt))
    ts = abstract_state(cfg, make_optimizer("adafactor", lambda s: 1.0))
    want = [tuple(x.shape) for x in jax.tree.leaves(js.opt_state)]
    got = [tuple(x.shape) for x in tree_flatten(ts.opt_state)[0]]
    assert got == want
    # a stacked (L, D) norm weight is factored, as in JAX
    assert set(ts.opt_state["layers"]["ln1"]) == {"r", "c"}


# ---------------- checkpoints of the state ----------------------------------------

def _files(root, step):
    d = Path(root) / f"step_{step:06d}"
    meta = json.loads((d / "meta.json").read_text())
    meta.pop("treedef")
    return {p.name: p.read_bytes() for p in d.glob("*.npy")}, meta


def test_checkpoint_of_the_state_is_the_reference_byte_for_byte(tmp_path):
    jcfg, cfg = jget("qwen3_1_7b").smoke(), get_config("qwen3_1_7b").smoke()
    jopt, _ = j_make_train_setup(jcfg)
    js = jax.device_get(j_init_state(jcfg, KEY, jopt))
    ts = from_reference_state(js, "cpu")
    JCkpt(str(tmp_path / "j"), 8, 4).save(5, js)
    tck = TCkpt(str(tmp_path / "t"), 8, 4, device="cpu")
    tck.save(5, ts)
    jf, jm = _files(tmp_path / "j", 5)
    tf, tm = _files(tmp_path / "t", 5)
    assert len(jf) == 12 and jf == tf
    assert jm == tm
    # the port restores JAX's checkpoint, degraded, to the state itself
    for failed in (frozenset(), {1, 3}):
        got = TCkpt(str(tmp_path / "j"), 8, 4, device="cpu").restore(
            5, ts, failed_shards=failed)
        assert isinstance(got, TrainState)
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(got)[0],
                                                     tree_flatten(ts)[0]))
    # and JAX restores the port's
    back = JCkpt(str(tmp_path / "t"), 8, 4).restore(5, js, failed_shards={0, 7})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    moved = state_to(got, "cpu")
    assert all(t.device.type == "cpu" for t in tree_flatten(moved)[0])
