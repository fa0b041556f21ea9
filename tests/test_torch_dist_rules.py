"""No op without a rule in the card's torch reaches a DTensor.

The card's machine has torch 2.11, whose DTensor lacks rules this
container's 2.13 has: for `aten.flip` (the backward of `cumsum`, in the
SSM's chunked scan), for `index_put` with a `None` index (the backward of
`x[:, idx]`, the MoE's token gather), and for advanced indexing whose
index tensors shard one dimension over two mesh dimensions (the MoE's
bucket scatter and gather, and their backward).  The model code runs those
ops on each rank's shards (`dist.ctx.along`, `layers._dispatch`,
`layers._combine`).  Here a dispatch mode records every op issued at the
DTensor level during a smoke-width `value_and_grad` of the SSM, hybrid
and MoE archs on meta DTensors of a fake 2x2 mesh, and none of those ops
is among them.  Without a repair the recorder does see its op.
"""
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.dist import activation_sharding
from repro_torch.launch import dryrun as D
from repro_torch.models import layers, ssm
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)

ARCHS = ["mamba2_780m", "hymba_1_5b", "phi3_5_moe_42b_a6_6b",
         "kimi_k2_1t_a32b"]
INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}


@pytest.fixture
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


class _DTensorOps(TorchDispatchMode):
    """Records (op name, arguments) of every op dispatched on DTensors;
    DTensor then runs it (and its local ops pass through)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.ops.append((func.overloadpacket.__name__, args))
            return NotImplemented
        return func(*args, **(kwargs or {}))


def _value_and_grad_ops(arch, mesh) -> list:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import model as M

    cfg = get_config(arch).smoke()
    shape = ShapeConfig("train_64", 64, 4, "train")
    _, (state, batch), _ = D.build_cell(cfg, shape, mesh, False)
    with _DTensorOps() as rec, activation_sharding(mesh), \
            implicit_replication():
        M.value_and_grad(cfg, state.params, batch)
    return rec.ops


def _none_index(args) -> bool:
    return (len(args) > 1 and isinstance(args[1], (list, tuple))
            and any(i is None for i in args[1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_no_op_without_a_rule_in_torch_2_11_reaches_a_dtensor(fake_mesh,
                                                              arch):
    ops = _value_and_grad_ops(arch, fake_mesh)
    names = {name for name, _ in ops}
    assert len(ops) > 100  # the step did run on DTensors
    assert "flip" not in names
    assert not any(_none_index(args) for _, args in ops)
    assert not INDEXING & names, sorted(INDEXING & names)


@pytest.mark.parametrize("arch, module, name, patch, op", [
    ("mamba2_780m", ssm, "along", lambda fn, x, dims: fn(x), "flip"),
    ("phi3_5_moe_42b_a6_6b", layers, "along", lambda fn, x, dims: fn(x),
     "index"),
    ("phi3_5_moe_42b_a6_6b", layers, "_combine",
     lambda b, bi, e, p: b[bi, e, p], "index")])
def test_the_recorder_sees_the_op_without_its_repair(fake_mesh, monkeypatch,
                                                     arch, module, name,
                                                     patch, op):
    monkeypatch.setattr(module, name, patch)
    ops = _value_and_grad_ops(arch, fake_mesh)
    assert op in {name for name, _ in ops}
    if name == "along" and op == "index":  # x[:, tok_idx]: a None index
        assert any(_none_index(args) for _, args in ops)
