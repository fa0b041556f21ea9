"""The port's coded checkpoints against the JAX package's, on the CPU
(`device="cpu"`: the kernels' plain versions).

The same leaves — numpy arrays through `repro.ckpt`, torch tensors through
`repro_torch.ckpt` — must give byte-identical shard and parity files and an
equal `meta.json` (bar its free-form "treedef" string); each package must
restore the other's checkpoints, healthy and degraded; and the JAX
package's own checkpoint scenarios (`tests/test_substrate.py`,
`tests/test_rebuild.py`) must hold for the port.  Exact: no tolerance."""
import json
import tempfile
from collections import OrderedDict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CodedCheckpointer as JCkpt
from repro.core.field import FERMAT
from repro_torch.ckpt import CodedCheckpointer as TCkpt
from repro_torch.ckpt import bytes_to_tree, tree_to_bytes
from repro_torch.core.field import FERMAT as TFERMAT
from repro_torch.core.parity import reconstruct

torch.set_num_threads(1)

Q = 65537


def _trees(seed=0):
    """(numpy tree for repro, torch tree for repro_torch): the same leaves
    — float32, bf16 (arbitrary bit patterns), int64, an empty leaf, a
    nested OrderedDict and a scalar step."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((37, 19)).astype(np.float32)
    bits = rng.integers(0, 1 << 16, (9, 13)).astype(np.uint16)
    i64 = rng.integers(-(1 << 40), 1 << 40, (23,)).astype(np.int64)
    mu = rng.standard_normal((5, 3)).astype(np.float32)
    jt = {"layer": {"w": f32, "b16": bits.view(jnp.bfloat16)}, "ids": i64,
          "empty": np.zeros((0, 4), np.float32),
          "opt": OrderedDict([("nu", i64[:5]), ("mu", mu)]),
          "step": np.int64(7)}
    tt = {"layer": {"w": torch.from_numpy(f32.copy()),
                    "b16": torch.from_numpy(bits.view(np.int16).copy())
                    .view(torch.bfloat16)},
          "ids": torch.from_numpy(i64.copy()),
          "empty": torch.zeros((0, 4), dtype=torch.float32),
          "opt": OrderedDict([("nu", torch.from_numpy(i64[:5].copy())),
                              ("mu", torch.from_numpy(mu.copy()))]),
          "step": torch.tensor(7)}
    return jt, tt


def _leaf_bytes(tree):
    """[(dtype name, shape, bytes)] in leaf order, read independently of
    the code under test (bf16 by its bits)."""
    def flat(node):
        if isinstance(node, dict):
            keys = node if isinstance(node, OrderedDict) else sorted(node)
            for k in keys:
                yield from flat(node[k])
        else:
            yield node

    out = []
    for x in flat(tree):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                out.append(("bfloat16", tuple(x.shape),
                            x.view(torch.int16).numpy().tobytes()))
            else:
                out.append((str(x.numpy().dtype), tuple(x.shape),
                            x.numpy().tobytes()))
        else:
            a = np.asarray(x)
            if a.dtype.name == "bfloat16":
                out.append(("bfloat16", a.shape, a.view(np.uint16).tobytes()))
            else:
                out.append((str(a.dtype), a.shape, a.tobytes()))
    return out


def _step_dir(root, step):
    return Path(root) / f"step_{step:06d}"


def _meta(root, step):
    return json.loads((_step_dir(root, step) / "meta.json").read_text())


# ---------------- byte identity with the JAX package -------------------------

@pytest.mark.parametrize("N,R", [(8, 4), (16, 4)])
def test_same_tree_gives_byte_identical_files(tmp_path, N, R):
    jt, tt = _trees(N)
    JCkpt(str(tmp_path / "j"), N, R).save(3, jt)
    TCkpt(str(tmp_path / "t"), N, R, device="cpu").save(3, tt)
    dj, dt = _step_dir(tmp_path / "j", 3), _step_dir(tmp_path / "t", 3)
    names = sorted(p.name for p in dj.glob("*.npy"))
    assert names == sorted(p.name for p in dt.glob("*.npy"))
    assert len(names) == N + R
    for name in names:
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name
    mj, mt = _meta(tmp_path / "j", 3), _meta(tmp_path / "t", 3)
    assert mj.pop("treedef") and mt.pop("treedef")
    assert mt == mj
    assert "torch" not in json.dumps(mt["leaves"])


def test_tree_to_bytes_matches_reference_and_numpy_leaves():
    from repro.ckpt import tree_to_bytes as j_tree_to_bytes

    jt, tt = _trees(5)
    raw_j, meta_j = j_tree_to_bytes(jt)
    for tree in (tt, jt):  # torch leaves and numpy leaves alike
        raw, meta = tree_to_bytes(tree)
        assert np.array_equal(raw, raw_j)
        assert meta["leaves"] == meta_j["leaves"]
        assert meta["nbytes"] == meta_j["nbytes"]
    back = bytes_to_tree(raw_j, meta_j, tt)
    assert _leaf_bytes(back) == _leaf_bytes(tt)
    assert isinstance(back["opt"], OrderedDict)
    assert list(back["opt"]) == ["nu", "mu"]


# ---------------- cross-restores --------------------------------------------

@pytest.mark.parametrize("failed", [frozenset(), frozenset({0, 3, 5, 7})])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_restore_both_ways(tmp_path, writer, failed):
    jt, tt = _trees(11)
    if writer == "jax":
        JCkpt(str(tmp_path), 8, 4).save(4, jt)
        got = TCkpt(str(tmp_path), 8, 4, device="cpu").restore(
            4, tt, failed_shards=set(failed))
        assert isinstance(got["layer"]["w"], torch.Tensor)
        assert got["layer"]["b16"].dtype == torch.bfloat16
        assert _leaf_bytes(got) == _leaf_bytes(tt)
    else:
        TCkpt(str(tmp_path), 8, 4, device="cpu").save(4, tt)
        got = JCkpt(str(tmp_path), 8, 4).restore(4, jt,
                                                 failed_shards=set(failed))
        assert _leaf_bytes(got) == _leaf_bytes(jt)


def test_port_restores_numpy_example_as_numpy(tmp_path):
    jt, tt = _trees(12)
    ck = TCkpt(str(tmp_path), 8, 4, device="cpu")
    ck.save(1, tt)
    got = ck.restore(1, jt, failed_shards={2})
    assert isinstance(got["ids"], np.ndarray)
    assert got["layer"]["b16"].dtype == jt["layer"]["b16"].dtype
    assert _leaf_bytes(got) == _leaf_bytes(jt)


# ---------------- the JAX package's checkpoint scenarios ---------------------

@pytest.mark.parametrize("failures", [set(), {0}, {1, 6}, {0, 3, 5, 7}])
def test_roundtrip_under_failure_sets(tmp_path, failures):
    _, tt = _trees(21)
    ck = TCkpt(str(tmp_path), n_shards=8, n_parity=4, device="cpu")
    ck.save(7, tt)
    assert ck.latest_step() == 7
    rest = ck.restore(7, tt, failed_shards=failures)
    assert _leaf_bytes(rest) == _leaf_bytes(tt)


def test_too_many_failures_raises(tmp_path):
    _, tt = _trees(22)
    ck = TCkpt(str(tmp_path), n_shards=8, n_parity=2, device="cpu")
    ck.save(1, tt)
    with pytest.raises(AssertionError):
        ck.restore(1, tt, failed_shards={0, 1, 2})


def test_background_save_and_elastic_reshard(tmp_path):
    _, tt = _trees(23)
    ck = TCkpt(str(tmp_path / "c"), n_shards=16, n_parity=4, device="cpu")
    ck.save(2, tt, background=True)
    ck.wait()
    ck2 = ck.reshard(2, new_n=4, new_r=2)
    assert (ck2.n_shards, ck2.n_parity) == (4, 2)
    assert ck2.device == "cpu"
    rest = ck2.restore(2, tt, failed_shards={3})
    assert _leaf_bytes(rest) == _leaf_bytes(tt)
    # the resharded files carry their own checksums: a scrub finds them clean
    rep = ck2.scrub(2)
    assert rep["rebuilt"] == [] and rep["checked"] == 6


def test_reshard_files_match_reference(tmp_path):
    jt, tt = _trees(24)
    jc = JCkpt(str(tmp_path / "j"), 16, 4)
    jc.save(2, jt)
    jc.reshard(2, new_n=4, new_r=2)
    tc = TCkpt(str(tmp_path / "t"), 16, 4, device="cpu")
    tc.save(2, tt)
    tc.reshard(2, new_n=4, new_r=2)
    dj, dt = _step_dir(tmp_path / "j_n4", 2), _step_dir(tmp_path / "t_n4", 2)
    for name in sorted(p.name for p in dj.glob("*.npy")):
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name
    # a restore through the JAX package reads the port's resharded files
    got = JCkpt(str(tmp_path / "t_n4"), 4, 2).restore(2, jt,
                                                       failed_shards={1})
    assert _leaf_bytes(got) == _leaf_bytes(jt)


def test_background_save_error_raises_from_wait(tmp_path, monkeypatch):
    _, tt = _trees(25)
    ck = TCkpt(str(tmp_path), 8, 4, device="cpu")

    def broken(shards):
        raise OSError("disk full")
        yield  # pragma: no cover

    monkeypatch.setattr(ck, "_parity_stream", broken)
    ck.save(1, tt, background=True)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()  # the error is raised once
    assert ck.latest_step() is None


@pytest.mark.parametrize("nbytes,seed", [(1, 0), (2, 1), (7, 2), (4097, 3),
                                         (1000, 4)])
def test_shard_symbols_roundtrip(nbytes, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
    with tempfile.TemporaryDirectory() as td:
        ck = TCkpt(td, n_shards=4, n_parity=2, device="cpu")
        jk = JCkpt(td + "_j", n_shards=4, n_parity=2)
        shards = ck.shard_symbols(raw)
        assert np.array_equal(shards, jk.shard_symbols(raw))
        parity = ck.encode_parity(shards)
        assert np.array_equal(parity, jk.encode_parity(shards))
        full = np.concatenate([shards, parity])
        kept = np.sort(rng.choice(6, 4, replace=False))
        rec = reconstruct(TFERMAT, ck.sgrs, kept, full[kept], device="cpu")
        assert np.array_equal(rec, shards)


# ---------------- scrub -----------------------------------------------------

def _damage(d):
    """One missing shard, one silently corrupt shard, one corrupt parity."""
    (d / "shard_002.npy").unlink()
    for name in ("shard_005.npy", "parity_001.npy"):
        arr = np.load(d / name)
        arr[7] = (arr[7] + 1) % Q
        np.save(d / name, arr)


def test_scrub_rebuilds_missing_and_corrupt_like_reference(tmp_path):
    state = {"w": np.arange(4096, dtype=np.float32).reshape(64, 64),
             "b": np.ones(777, dtype=np.float32)}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    jc = JCkpt(str(tmp_path / "j"), n_shards=8, n_parity=4)
    tc = TCkpt(str(tmp_path / "t"), n_shards=8, n_parity=4, device="cpu")
    jc.save(3, state)
    tc.save(3, tstate)
    d = _step_dir(tmp_path / "t", 3)
    assert len(_meta(tmp_path / "t", 3)["sha256"]) == 12
    clean = tc.scrub(3)
    assert clean["rebuilt"] == [] and clean == jc.scrub(3)
    originals = {p.name: p.read_bytes() for p in d.glob("*.npy")}
    _damage(d)
    _damage(_step_dir(tmp_path / "j", 3))
    rep = tc.scrub()  # default: latest step
    assert rep == jc.scrub()
    assert rep["missing"] == [2] and sorted(rep["corrupt"]) == [5, 9]
    assert rep["rebuilt"] == [2, 5, 9] and rep["verified"]
    # in-place rebuild is bitwise: every file is back, byte for byte
    assert {p.name: p.read_bytes() for p in d.glob("*.npy")} == originals
    assert not list(d.glob(".scrub_*"))
    assert tc.scrub(3)["rebuilt"] == []
    got = tc.restore(3, tstate)
    assert all(torch.equal(got[k], tstate[k]) for k in state)
    # beyond R damaged files the scrub refuses loudly
    for k in (0, 1, 3, 4, 6):
        (d / f"shard_00{k}.npy").unlink()
    with pytest.raises(RuntimeError, match="unrecoverable"):
        tc.scrub(3)


def test_scrub_flags_unparseable_and_wrong_shape_files(tmp_path):
    _, tt = _trees(31)
    ck = TCkpt(str(tmp_path), n_shards=8, n_parity=4, device="cpu")
    ck.save(1, tt)
    d = _step_dir(tmp_path, 1)
    before = (d / "shard_001.npy").read_bytes()
    (d / "shard_001.npy").write_bytes(b"not an npy file")
    np.save(d / "parity_000.npy", np.zeros(3, np.uint32))
    rep = ck.scrub(1)
    assert rep["corrupt"] == [1, 8] and rep["rebuilt"] == [1, 8]
    assert (d / "shard_001.npy").read_bytes() == before


# ---------------- torch modules ---------------------------------------------

def test_module_state_dict_roundtrip_through_load_state_dict(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(12, 7), torch.nn.LayerNorm(7),
                              torch.nn.Linear(7, 3)).to(torch.bfloat16)
    net.register_buffer("steps", torch.tensor([5], dtype=torch.int64))
    sd = net.state_dict()
    assert isinstance(sd, OrderedDict)
    ck = TCkpt(str(tmp_path), n_shards=4, n_parity=2, device="cpu")
    ck.save(9, sd)
    other = torch.nn.Sequential(torch.nn.Linear(12, 7), torch.nn.LayerNorm(7),
                                torch.nn.Linear(7, 3)).to(torch.bfloat16)
    other.register_buffer("steps", torch.tensor([0], dtype=torch.int64))
    restored = ck.restore(9, other.state_dict(), failed_shards={0, 2})
    assert list(restored) == list(sd)  # insertion order kept
    other.load_state_dict(restored)
    for k, v in other.state_dict().items():
        assert v.dtype == sd[k].dtype
        assert torch.equal(v.view(torch.int16) if v.dtype == torch.bfloat16
                           else v, sd[k].view(torch.int16)
                           if v.dtype == torch.bfloat16 else sd[k]), k


def test_checkpointer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TCkpt(str(tmp_path))
    # a non-Fermat field runs on the host-only simulator: no device at all
    from repro_torch.core.field import Field

    ck = TCkpt(str(tmp_path / "f"), 4, 2, field=Field(65539))
    assert ck._system.device is None
    assert FERMAT.q == TFERMAT.q == Q


# ---------------- sessions and tracing --------------------------------------

@pytest.mark.parametrize("op", ["restore", "scrub"])
def test_repair_session_is_closed_when_its_stream_fails(tmp_path, monkeypatch,
                                                        op):
    _, tt = _trees(41)
    ck = TCkpt(str(tmp_path), n_shards=8, n_parity=4, device="cpu")
    ck.save(1, tt)
    (_step_dir(tmp_path, 1) / "shard_003.npy").unlink()
    opened, closed = [], []
    real = ck._session

    def session(spec):
        s = real(spec)

        def broken(*a, **k):
            raise OSError("survivor read failed")

        s.decode_stream = s.rebuild_stream = broken
        s.close = lambda: closed.append(s)
        opened.append(s)
        return s

    monkeypatch.setattr(ck, "_session", session)
    with pytest.raises(OSError, match="survivor read failed"):
        ck.restore(1, tt) if op == "restore" else ck.scrub(1)
    assert len(opened) == 1 and closed == opened


def test_stages_are_spans_on_the_installed_tracer(tmp_path):
    from repro_torch.obs import trace

    _, tt = _trees(42)
    ck = TCkpt(str(tmp_path), n_shards=8, n_parity=4, device="cpu",
               chunk_w=64)
    with trace.installed() as tr:
        ck.save(1, tt)
        ck.save(2, tt, background=True)
        ck.wait()
        ck.restore(1, tt, failed_shards={0, 5})
        (_step_dir(tmp_path, 1) / "shard_002.npy").unlink()
        ck.scrub(1)
    spans = tr.events(cat="ckpt")
    names = [e["name"] for e in spans]
    for name in ("tree_to_bytes", "shard_symbols", "degraded_read",
                 "assemble", "bytes_to_tree", "verify", "rebuild"):
        assert name in names, name
    for name in ("shard_files", "parity"):
        assert names.count(name) == 2, name  # both saves
    L = -(-(-(-_meta(tmp_path, 1)["nbytes"] // 2)) // 8)  # symbols a shard
    assert names.count("parity_write") == 2 * -(-L // 64)
    # the background save's file stages sit on its worker's own row
    files = [e for e in spans if e["name"] == "shard_files"]
    assert files[0]["tid"] != files[1]["tid"]
    # a parity span holds its chunks' writes and the stream's own spans
    par = [e for e in spans if e["name"] == "parity"][0]
    inside = [e for e in tr.events() if e["tid"] == par["tid"]
              and e["pid"] == par["pid"] and e["name"] == "parity_write"
              and par["ts"] <= e["ts"] <= par["ts"] + par["dur"]]
    assert len(inside) == -(-L // 64)
    assert tr.events(cat="stream")


# ---------------------------------------------------------------------------
# tree nodes are JAX's: exact containers, namedtuples, OrderedDict and
# defaultdict; every other list, tuple or dict subclass is a leaf
# ---------------------------------------------------------------------------

class _TS(tuple):
    pass


class _DS(dict):
    pass


class _ArrayDS(dict):
    """A dict subclass with an array form, so that as a leaf it has bytes."""

    def __array__(self, dtype=None, copy=None):
        return np.asarray([self[k] for k in sorted(self)], dtype=dtype)


class _LS(list):
    pass


_NT = __import__("collections").namedtuple("_NT", "a b")


def _subclass_trees():
    from collections import defaultdict

    dd = defaultdict(list)
    dd["z"], dd["a"] = np.int32(3), np.float32(2.5)
    return {
        "torch.Size": {"x": torch.Size([3, 4])},
        "tuple subclass": {"x": _TS((np.int32(1), np.int32(2)))},
        "dict subclass": {"x": _ArrayDS(b=np.int32(7), a=np.int32(9))},
        "namedtuple": {"x": _NT(np.int32(1), np.float32(2.0)), "y": [1.5]},
        "OrderedDict": {"x": OrderedDict([("b", np.int32(1)),
                                          ("a", np.int64(5))])},
        "defaultdict": {"x": dd, "s": np.int64(4)},
    }


@pytest.mark.parametrize("name", list(_subclass_trees()))
def test_subclass_trees_match_reference_and_round_trip(name):
    from repro.ckpt.checkpoint import bytes_to_tree as j_bytes_to_tree
    from repro.ckpt.checkpoint import tree_to_bytes as j_tree_to_bytes

    tree = _subclass_trees()[name]
    rj, mj = j_tree_to_bytes(tree)
    rt, mt = tree_to_bytes(tree)
    assert mt["leaves"] == mj["leaves"] and mt["nbytes"] == mj["nbytes"]
    assert np.array_equal(rt, rj)
    back, jback = bytes_to_tree(rt, mt, tree), j_bytes_to_tree(rj, mj, tree)
    assert type(back) is type(jback)
    for key in tree:
        assert type(back[key]) is type(jback[key]), key
        got = back[key].values() if isinstance(back[key], dict) else (
            back[key] if isinstance(back[key], (list, tuple)) else [back[key]])
        want = jback[key].values() if isinstance(jback[key], dict) else (
            jback[key] if isinstance(jback[key], (list, tuple))
            else [jback[key]])
        for a, b in zip(got, want, strict=True):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.array_equal(np.asarray(a), np.asarray(b))
    if name == "defaultdict":
        assert back["x"].default_factory is list
        assert list(back["x"]) == ["a", "z"]


def test_subclasses_are_leaves_as_in_jax():
    import jax

    from repro_torch.core.pytree import tree_flatten, tree_unflatten

    tree = {"t": _TS((1, 2)), "d": _DS(a=1), "l": _LS([3]),
            "s": torch.Size([2]), "n": _NT(4, [5, (6,)]),
            "o": OrderedDict([("k", 7)])}
    leaves, treedef = tree_flatten(tree)
    jleaves = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(jleaves) == 8
    assert all(a is b for a, b in zip(leaves, jleaves))
    back = tree_unflatten(treedef, leaves)
    assert back["t"] is tree["t"] and back["d"] is tree["d"]
    assert type(back["n"]) is _NT and back["n"].b == [5, (6,)]
