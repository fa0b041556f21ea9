"""Loop-trip scaling in the port's census (`launch.hlo_cost.repeat`).

The JAX census multiplies a `while` body by its trip count; the port's
census runs the first iteration of a `repeat(n, t)` loop (on meta tensors)
and counts its ops n times.  Here the chunked attention's two loops are
counted both ways, scaled and unrolled (`layers.repeat` replaced by
`range`): the FLOPs are equal exactly, and so are the bytes and the
collectives by kind, on meta tensors and on meta DTensors of a fake 16x16
group, at the function and through a few layers of a model's prefill.
Outside a census `_chunked` runs every iteration: on CPU tensors it is
bitwise the loop it replaced, inside a census as well as outside.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist import activation_sharding
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_cost import analyze, trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers
from repro_torch.models.config import ShapeConfig

torch.set_num_threads(1)


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


def _unrolled(monkeypatch):
    monkeypatch.setattr(layers, "repeat", lambda n, like: range(n))


def _same(scaled: dict, unrolled: dict) -> None:
    assert scaled["flops"] == unrolled["flops"]
    assert scaled["flops_by_op"] == unrolled["flops_by_op"]
    assert scaled["bytes"] == unrolled["bytes"]
    assert scaled["collective_bytes"] == unrolled["collective_bytes"]
    assert scaled["collectives_by_kind"] == unrolled["collectives_by_kind"]


def _qkv(B, S, H, KV, hd, make):
    return (make((B, S, H, hd)), make((B, S, KV, hd)), make((B, S, KV, hd)))


@pytest.mark.parametrize("window", [0, 1024])
def test_scaled_census_equals_unrolled_on_meta_tensors(monkeypatch, window):
    cfg = get_config("qwen3_1_7b")
    q, k, v = _qkv(2, 8192, 8, 2, cfg.hd, lambda s: torch.empty(
        s, dtype=torch.bfloat16, device="meta"))

    def attend(q, k, v):
        return layers._chunked_attention(q, k, v, cfg, True, window)

    analyze(attend, q, k, v)  # fills caches, counted in the first run only
    scaled = analyze(attend, q, k, v)
    _unrolled(monkeypatch)
    unrolled = analyze(attend, q, k, v)
    _same(scaled, unrolled)
    # the kv loop's four (q-chunk x kv-chunk) score blocks and its product
    # with v, or the window's one block, in each of 16 q chunks
    cols = 8192 if window == 0 else window + 512
    assert scaled["flops_by_op"]["aten.bmm"] == 2 * (
        2 * 2 * 8 * 8192 * cols * cfg.hd)


@pytest.mark.parametrize("window", [0, 1024])
def test_scaled_census_equals_unrolled_on_meta_dtensors(fake_group,
                                                        monkeypatch, window):
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config("qwen3_1_7b")
    fake_group(256)
    mesh = make_production_mesh()

    def make(shape):
        local = (shape[0] // 16, shape[1], shape[2] // 16, shape[3])
        return DTensor.from_local(
            torch.empty(local, dtype=torch.bfloat16, device="meta"), mesh,
            [Shard(0), Shard(2)], run_check=False)

    q, k, v = _qkv(32, 8192, 32, 32, cfg.hd, make)

    def attend(q, k, v):
        with activation_sharding(mesh), implicit_replication():
            return layers._chunked_attention(q, k, v, cfg, True, window)

    analyze(attend, q, k, v)  # fills caches, counted in the first run only
    scaled = analyze(attend, q, k, v)
    _unrolled(monkeypatch)
    unrolled = analyze(attend, q, k, v)
    _same(scaled, unrolled)
    assert scaled["flops"] > 0


@pytest.mark.parametrize("arch", ["qwen3_1_7b", "hymba_1_5b"])
def test_scaled_census_equals_unrolled_through_a_prefill(fake_group,
                                                         monkeypatch, arch):
    """A smoke-width model (2 layers) prefilling 4096 tokens on meta
    DTensors of a fake 16x16 group, the chunked path taken from 2048 up:
    causal full attention (qwen3) and a sliding window (hymba)."""
    from torch.distributed.tensor.experimental import implicit_replication

    monkeypatch.setattr(layers, "CHUNKED_ATTN_THRESHOLD", 2048)
    cfg = get_config(arch).smoke()
    shape = ShapeConfig("prefill_4k", 4096, 16, "prefill")
    fake_group(256)
    mesh = make_production_mesh()

    def census():
        fn, args, _ = D.build_cell(cfg, shape, mesh, False)
        with activation_sharding(mesh), implicit_replication():
            return trace(fn, *args)[1]

    census()  # the first run fills caches (rope frequencies), counted once
    scaled = census()
    _unrolled(monkeypatch)
    unrolled = census()
    _same(scaled, unrolled)
    assert scaled["flops_by_op"]["aten.bmm"] > 0


def _chunked_unrolled(q, k, v, scale: float, causal: bool, window: int):
    """`layers._chunked` as it was before `repeat`: two plain loops."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    cq = min(layers._Q_CHUNK, Sq)
    nq = Sq // cq
    dev = q.device
    qs = q.reshape(B, nq, cq, H, hd)
    blocks = []
    for qi in range(nq):
        qb = qs[:, qi] * scale
        q_start = qi * cq
        qpos = q_start + torch.arange(cq, device=dev)[:, None]
        if window > 0:
            kw = window + cq
            start = min(max(q_start + cq - kw, 0), max(Skv - kw, 0))
            width = min(kw, Skv)
            kb, vb = k[:, start:start + width], v[:, start:start + width]
            s = layers._einsum("bqhd,bkhd->bhqk", qb, kb).float()
            kpos = start + torch.arange(width, device=dev)[None, :]
            msk = (kpos <= qpos) & (kpos > qpos - window)
            s = torch.where(msk[None, None], s, -1e30)
            w = torch.softmax(s, dim=-1).to(qb.dtype)
            blocks.append(layers._einsum("bhqk,bkhd->bqhd", w, vb))
            continue
        ck = min(layers._KV_CHUNK, Skv)
        m = torch.full((B, H, cq), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd), dtype=torch.float32, device=dev)
        for ki in range(Skv // ck):
            kb = k[:, ki * ck:(ki + 1) * ck]
            vb = v[:, ki * ck:(ki + 1) * ck]
            s = layers._einsum("bqhd,bkhd->bhqk", qb, kb).float()
            if causal:
                kpos = ki * ck + torch.arange(ck, device=dev)[None, :]
                s = torch.where((kpos <= qpos)[None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + layers._einsum(
                "bhqk,bkhd->bhqd", p.to(qb.dtype), vb).float()
            m = m_new
        ob = (acc / l[..., None]).to(qb.dtype)
        blocks.append(ob.transpose(1, 2))
    return torch.stack(blocks, dim=1).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("window", [0, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_on_real_tensors_is_bitwise_the_unrolled_loop(window, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2048, 2, 16),
                                                    dtype=np.float32)).to(dtype)
               for _ in range(3))
    want = _chunked_unrolled(q, k, v, 0.25, True, window)
    got = layers._chunked(q, k, v, 0.25, True, window)
    assert torch.equal(got, want)
    counted = trace(layers._chunked, q, k, v, 0.25, True, window)[0]
    assert torch.equal(counted, want)


def test_repeat_is_range_outside_a_census_and_off_meta():
    from repro_torch.launch.hlo_cost import repeat

    meta = torch.empty(1, device="meta")
    assert list(repeat(5, meta)) == list(range(5))
    seen = []

    def loop(t):
        seen.append(list(repeat(5, t)))
        return t

    trace(loop, meta)
    trace(loop, torch.zeros(1))
    assert seen == [[0], list(range(5))]
