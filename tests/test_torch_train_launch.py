"""The port's training launcher (`repro_torch.launch.train`) in process on
the CPU (`--device cpu`): the JAX launcher's failure-injection scenario
(`tests/test_launch.py::test_train_launcher_failure_injection`), the
straggler self-check in each mode, `--resume` from a checkpoint the port
wrote and from one the JAX package wrote (the state restored bit for
bit), the device default, which raises without a card, and
`--production`, which changes nothing.
"""
import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CodedCheckpointer as JCkpt
from repro.configs import get_config as jget
from repro.train import init_state as j_init_state
from repro.train import make_train_setup as j_make_train_setup
from repro.train import make_train_step as j_make_train_step
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.core.pytree import tree_flatten
from repro_torch.launch import train as LT

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--seq-len", "16", "--batch", "4"]


def _on_cpu(state):
    return all(t.device.type == "cpu" for t in tree_flatten(state)[0])


def test_failure_injection(tmp_path, capsys):
    res = LT.main(["--arch", "qwen3_1_7b", "--steps", "25", "--ckpt-dir",
                   str(tmp_path / "ck"), "--ckpt-every", "10", "--fail-at",
                   "12,1,3", "--peak-lr", "5e-3", "--seq-len", "64",
                   "--batch", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "reconstructed from parity; resumed at step 10" in out
    assert "done: final loss" in out
    assert int(res.state.step) == 25 - 12 + 10 - 1  # the JAX loop's count
    assert _on_cpu(res.state) and np.isfinite(res.losses).all()
    ops = [op for op, _, _ in res.ckpt_ops]
    assert ops == ["save", "wait", "restore", "save", "final_save"]
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_000010", "step_000020", "step_000025"]


@pytest.mark.parametrize("mode", ["random", "bursty", "fixed"])
def test_straggler_selfcheck(tmp_path, capsys, mode):
    res = LT.main(["--steps", "4", "--stragglers", "1", "--coded-workers",
                   "4", "--straggler-selfcheck", "--straggler-mode", mode,
                   "--log-every", "2"] + SMALL)
    out = capsys.readouterr().out
    assert "gradient coding: 4 workers, s=1 tolerated, 2 groups" in out
    assert "selfcheck OK: step with stragglers" in out
    assert "bitwise == all-alive" in out
    assert f"worker-steps decoded around ({mode}, s=1)" in out
    assert res.straggled >= (4 if mode == "fixed" else 0)
    assert int(res.state.step) == 4


def test_straggler_flags_refuse_an_uneven_batch():
    with pytest.raises(SystemExit, match="must be divisible"):
        LT.main(["--steps", "1", "--stragglers", "1", "--coded-workers", "8",
                 "--device", "cpu", "--batch", "4"])


def test_resume_from_the_ports_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    first = LT.main(["--steps", "6", "--ckpt-dir", ck, "--ckpt-every", "3",
                     "--compress-grads", "--microbatches", "2"] + SMALL)
    again = LT.main(["--steps", "6", "--ckpt-dir", ck, "--resume"] + SMALL)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_flatten(first.state)[0], tree_flatten(again.state)[0]))
    more = LT.main(["--steps", "9", "--ckpt-dir", ck, "--resume"] + SMALL)
    out = capsys.readouterr().out
    assert out.count("resumed from coded checkpoint step 6") == 2
    assert "done: no step to run (state at step 6)" in out
    assert "step     7 loss=" in out
    assert int(more.state.step) == 9 and len(more.losses) == 3
    assert _on_cpu(more.state)


def test_resume_from_the_reference_checkpoint(tmp_path, capsys):
    jcfg = jget("qwen3_1_7b").smoke()
    jopt, _ = j_make_train_setup(jcfg, total_steps=5, peak_lr=3e-3)
    js = j_init_state(jcfg, jax.random.PRNGKey(0), jopt)
    step = jax.jit(j_make_train_step(jcfg, jopt))
    data = JSyntheticLM(jcfg.vocab, 16, 4)
    for i in range(2):
        js, _ = step(js, data.device_batch(i))
    js = jax.device_get(js)
    ck = str(tmp_path / "ck")
    JCkpt(ck, 16, 4).save(2, js)
    res = LT.main(["--steps", "2", "--ckpt-dir", ck, "--resume"] + SMALL)
    leaves = tree_flatten(res.state)[0]
    ref = jax.tree.leaves(js)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
        assert a.tobytes() == np.asarray(b).tobytes()
    res = LT.main(["--steps", "4", "--ckpt-dir", ck, "--resume"] + SMALL)
    assert "resumed from coded checkpoint step 2" in capsys.readouterr().out
    assert int(res.state.step) == 4 and np.isfinite(res.losses).all()


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LT.main(["--steps", "1"])


def test_production_flag_changes_nothing(capsys):
    """`--production` (the JAX launcher's 512 forced host devices) is
    accepted; the losses and the state are the run's without it, bitwise,
    and no process group is left behind."""
    import torch.distributed as dist

    argv = ["--steps", "3", "--log-every", "1"] + SMALL
    plain = LT.main(argv)
    prod = LT.main(argv + ["--production"])
    assert prod.losses == plain.losses and len(prod.losses) == 3
    assert all(torch.equal(a, b) for a, b in zip(
        tree_flatten(plain.state)[0], tree_flatten(prod.state)[0]))
    assert not dist.is_initialized()
