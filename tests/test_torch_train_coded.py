"""The JAX package's training scenarios within the port: the train loop
learns, microbatching and int8 compression (`tests/test_substrate.py`),
the straggler-coded step and `StragglerInjector` (`tests/test_coding.py`),
at JAX's tolerances.  The straggled step equals the all-alive step bit
for bit for every tested pattern of at most s stragglers, and more than s
in a group raises before any work.  The injector's plans are JAX's for
every mode and seed tried.
"""
import numpy as np
import pytest
import torch

from repro.coding import GradientCoder as JGradientCoder
from repro.train import StragglerInjector as JStragglerInjector
from repro_torch.coding import GradientCoder
from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_flatten
from repro_torch.data import SyntheticLM
from repro_torch.train import (
    StragglerInjector,
    init_state,
    make_straggler_train_step,
    make_train_setup,
    make_train_step,
)
from repro_torch.train.coded_step import deterministic

torch.set_num_threads(1)


def _state(cfg, total_steps, peak_lr=5e-3):
    opt, _ = make_train_setup(cfg, total_steps=total_steps, peak_lr=peak_lr)
    return opt, init_state(cfg, torch.Generator().manual_seed(0), opt, "cpu")


# ---------------- train loop (tests/test_substrate.py) ------------------------

def test_train_learns_and_microbatch_consistency():
    cfg = get_config("qwen3_1_7b").smoke()
    opt, state = _state(cfg, 100)
    data = SyntheticLM(cfg.vocab, 32, 8)
    step1 = make_train_step(cfg, opt, microbatches=1)
    step2 = make_train_step(cfg, opt, microbatches=2)
    b = data.device_batch(0, "cpu")
    _, m1 = step1(state, b)
    _, m2 = step2(state, b)
    # same data, same params: microbatched loss equals full-batch loss
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=2e-2)
    losses = []
    for i in range(20):
        state, m = step1(state, data.device_batch(i, "cpu"))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.05


def test_int8_grad_compression_trains():
    cfg = get_config("qwen3_1_7b").smoke()
    opt, state = _state(cfg, 50)
    step = make_train_step(cfg, opt, compress_grads=True)
    data = SyntheticLM(cfg.vocab, 32, 4)
    losses = []
    for i in range(15):
        state, m = step(state, data.device_batch(i, "cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# ---------------- coded step (tests/test_coding.py) ----------------------------

@pytest.fixture(scope="module")
def tiny_train():
    cfg = get_config("qwen3_1_7b").smoke()
    opt, state = _state(cfg, 20)
    batch = SyntheticLM(cfg.vocab, 16, 8).device_batch(0, "cpu")
    return cfg, opt, state, batch


def _trees_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def test_coded_step_bitwise_recovery(tiny_train):
    cfg, opt, state, batch = tiny_train
    coder = GradientCoder(4, s=1)
    step = make_straggler_train_step(cfg, opt, coder)
    ref_state, ref_m = step(state, batch)  # all alive
    for dead in [{0}, {1}, {2}, {3}, {0, 2}, {1, 3}, {0, 3}]:
        alive = np.array([w not in dead for w in range(4)])
        got_state, got_m = step(state, batch, alive)
        assert _trees_equal(got_state, ref_state)
        assert torch.equal(got_m["loss"], ref_m["loss"])
        assert got_m["stragglers"] == len(dead)
    # two stragglers in distinct groups with s=2 coding, and two in one
    coder2 = GradientCoder(6, s=2)
    step2 = make_straggler_train_step(cfg, opt, coder2)
    batch6 = SyntheticLM(cfg.vocab, 16, 12).device_batch(0, "cpu")
    ref6, _ = step2(state, batch6)
    for dead in ([0, 4], [1, 2], [3, 5]):
        alive = np.ones(6, bool)
        alive[dead] = False
        got6, _ = step2(state, batch6, alive)
        assert _trees_equal(got6.params, ref6.params)


def test_coded_step_close_to_uncoded_step(tiny_train):
    cfg, opt, state, batch = tiny_train
    coder = GradientCoder(4, s=1)
    coded = make_straggler_train_step(cfg, opt, coder)
    plain = make_train_step(cfg, opt)
    s1, m1 = coded(state, batch)
    s2, m2 = plain(state, batch)
    # different reduction association (per-part vs whole-batch), so
    # allclose, not bitwise
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_flatten(s1.params)[0], tree_flatten(s2.params)[0]):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


def test_coded_step_guards(tiny_train, monkeypatch):
    from repro_torch.models import model as M

    cfg, opt, state, batch = tiny_train
    coder = GradientCoder(4, s=1)
    step = make_straggler_train_step(cfg, opt, coder)
    calls = []

    def reached(*args):
        calls.append(args)
        raise AssertionError("reached the model")

    monkeypatch.setattr(M, "value_and_grad", reached)
    alive = np.ones(4, bool)
    alive[[0, 1]] = False  # wipes group 0
    with pytest.raises(RuntimeError, match="fully straggled"):
        step(state, batch, alive)
    bad_batch = SyntheticLM(cfg.vocab, 16, 6).device_batch(0, "cpu")  # 6 % 4
    with pytest.raises(ValueError, match="not divisible"):
        step(state, bad_batch)
    with pytest.raises(ValueError, match="alive must be"):
        step(state, batch, np.ones(5, bool))
    assert calls == []  # every guard fired before any model work


def test_coded_step_metrics_and_trace(tiny_train):
    from repro_torch.obs import metrics, trace

    cfg, opt, state, batch = tiny_train
    coder = GradientCoder(4, s=1)
    step = make_straggler_train_step(cfg, opt, coder)
    tracer = trace.Tracer()
    trace.install(tracer)
    try:
        before = metrics.REGISTRY.snapshot()
        alive = np.ones(4, bool)
        alive[2] = False
        step(state, batch, alive)
        after = metrics.REGISTRY.snapshot()
        spans = tracer.events(cat="train.step")
    finally:
        trace.uninstall(tracer)
    assert spans and spans[-1]["args"]["stragglers"] == [2]
    assert spans[-1]["name"] == "coded_train_step"

    def total(snap, name):
        return sum(snap.get(name, {}).get("values", {}).values())

    assert total(after, "coded_train_steps_total") == \
        total(before, "coded_train_steps_total") + 1
    assert total(after, "coded_train_stragglers_total") == \
        total(before, "coded_train_stragglers_total") + 1
    hist = after.get("coded_train_step_us", {}).get("values", {})
    assert any(v["count"] >= 1 for v in hist.values())


def test_deterministic_mode_is_for_cuda_only_and_restored():
    was = torch.are_deterministic_algorithms_enabled()
    with deterministic(torch.device("cpu")):
        assert torch.are_deterministic_algorithms_enabled() == was
    assert torch.are_deterministic_algorithms_enabled() == was


# ---------------- StragglerInjector ------------------------------------------------

@pytest.mark.parametrize("mode", ["random", "bursty", "fixed"])
def test_straggler_injector_masks_decodable(mode):
    coder = GradientCoder(6, s=2)
    inj = StragglerInjector.build(mode, coder, steps=40, rate=0.8, seed=3)
    n_straggled_steps = 0
    for t in range(40):
        mask = inj.mask(t)
        coder.decode_weights(mask)  # never raises: patterns keep <= s
        assert (~mask).sum() <= coder.s
        n_straggled_steps += int(not mask.all())
    assert n_straggled_steps > 0  # rate=0.8 over 40 steps must fire
    assert inj.plan and all(0 <= w < 6 for _, w in inj.plan)
    assert inj.injector.net.pending_kills  # lives on a real RoundNetwork


def test_straggler_injector_fixed_and_bounds():
    coder = GradientCoder(6, s=1)
    inj = StragglerInjector.fixed(coder, steps=5, workers=[4])
    for t in range(5):
        assert list(np.flatnonzero(~inj.mask(t))) == [4]
    with pytest.raises(ValueError, match="exceed tolerance"):
        StragglerInjector.fixed(coder, steps=5, workers=[0, 1])
    with pytest.raises(ValueError, match="unknown straggler mode"):
        StragglerInjector.build("flaky", coder, steps=5)


@pytest.mark.parametrize("mode", ["random", "bursty", "fixed"])
@pytest.mark.parametrize("n,s,seed,rate", [(6, 2, 3, 0.8), (4, 1, 0, 0.5),
                                           (8, 3, 11, 0.3), (9, 2, 7, 1.0)])
def test_straggler_injector_plans_are_the_reference(mode, n, s, seed, rate):
    got = StragglerInjector.build(mode, GradientCoder(n, s), 50, rate=rate,
                                  seed=seed)
    want = JStragglerInjector.build(mode, JGradientCoder(n, s), 50, rate=rate,
                                    seed=seed)
    assert [(int(a), int(b)) for a, b in got.plan] == \
        [(int(a), int(b)) for a, b in want.plan]
    for t in range(50):
        assert np.array_equal(got.mask(t), want.mask(t))
    assert got.injector.net.pending_kills == want.injector.net.pending_kills
