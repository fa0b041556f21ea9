"""The port's CodedSystem quickstart against the JAX package's, bitwise, on
the CPU (`device="cpu"`: the kernels' plain versions), plus the port's
device default and its import isolation from the JAX package."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.recover import UndecodableError as JUndecodable
from repro_torch.api import Backend, register_backend, unregister_backend
from repro_torch.api import CodedSystem as TSystem
from repro_torch.api import CodeSpec as TSpec
from repro_torch.recover import Decoder, UndecodableError
from torch_payloads import KINDS, payload

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
Q = 65537
W = 40

# (kind, K, R, seed, local_impl)
SPECS = [("rs", 16, 4, None, "ntt"), ("rs", 24, 6, None, "dense"),
         ("universal", 12, 4, 0, "dense"), ("lagrange", 8, 8, None, "ntt"),
         ("lagrange", 4, 8, None, "ntt"), ("dft", 16, 16, None, "ntt")]


def _pair(kind, K, R, seed):
    j = JSystem(JSpec(kind=kind, K=K, R=R, seed=seed), backend="local")
    t = TSystem(TSpec(kind=kind, K=K, R=R, seed=seed), backend="local",
                device="cpu")
    return j, t


def _counts(cost):
    """(C1, C2) of either package's `LinearCost` (two distinct classes)."""
    return cost.C1, cost.C2


def _pattern(K, R):
    """Three erasures mixing data and parity (<= R for every spec here)."""
    return sorted({1, K // 2, K + R - 1})


@pytest.mark.parametrize("kind,K,R,seed,impl", SPECS)
def test_quickstart_matches_reference(kind, K, R, seed, impl):
    j, t = _pair(kind, K, R, seed)
    je, te = j.encode_plan, t.encode_plan
    assert te.local_impl == je.local_impl == impl
    assert te.method == je.method
    assert _counts(te.cost()) == _counts(je.cost())
    assert np.array_equal(te.A, je.A)

    x = np.random.default_rng(K * 7 + R).integers(0, Q, (K, W))
    cw = t.codeword(x)
    assert np.array_equal(cw, j.codeword(x))

    for sys_ in (j, t):
        sys_.fail(_pattern(K, R))
    assert t.failed == j.failed
    assert t.kept == j.kept
    jd, td = j.decode_plan, t.decode_plan
    assert np.array_equal(td.D, jd.D)
    assert np.array_equal(td.tables.Dd, jd.tables.Dd)
    assert _counts(td.cost()) == _counts(jd.cost())
    lost = cw.copy()
    lost[list(t.failed)] = 0            # failed rows carry nothing
    survivors = cw[list(t.kept)]
    assert np.array_equal(t.decode(lost), j.decode(lost))
    assert np.array_equal(t.decode(survivors), cw[list(t.failed)])
    assert np.array_equal(t.read(lost), x)
    assert np.array_equal(t.read(survivors), j.read(survivors))

    # rebuild from survivors only (complement plan), then from the codeword
    healed = t.rebuild(survivors)
    assert np.array_equal(healed, j.rebuild(survivors))
    assert np.array_equal(healed, cw)
    assert t.failed == j.failed == ()
    for sys_ in (j, t):
        sys_.fail(_pattern(K, R))
    healed = t.rebuild(lost)
    assert np.array_equal(healed, j.rebuild(lost))
    assert np.array_equal(healed, cw)

    for sys_ in (j, t):
        sys_.fail([0]).heal()
    assert t.failed == j.failed == ()
    assert np.array_equal(t.read(cw), j.read(cw))


@pytest.mark.parametrize("kind,K,R,seed", [("rs", 16, 4, None),
                                           ("universal", 12, 4, 0)])
def test_codewords_cross_between_packages(kind, K, R, seed):
    j, t = _pair(kind, K, R, seed)
    x = np.random.default_rng(5).integers(0, Q, (K, W))
    cw_j, cw_t = j.codeword(x), t.codeword(x)
    for sys_ in (j, t):
        sys_.fail(_pattern(K, R))
    lost_j, lost_t = cw_j.copy(), cw_t.copy()
    lost_j[list(j.failed)] = 0
    lost_t[list(t.failed)] = 0
    assert np.array_equal(t.read(lost_j), x)        # JAX codeword, port read
    assert np.array_equal(j.read(lost_t), x)        # port codeword, JAX read
    assert np.array_equal(t.rebuild(lost_j), cw_j)
    assert np.array_equal(j.rebuild(lost_t), cw_t)


OPS = ["codeword", "encode", "read", "rebuild", "decode"]


def _run(system, op, x, v, dead):
    """One op of `system` on the (K, W) data x or the (N, W) rows v."""
    if op in ("codeword", "encode"):
        return getattr(system, op)(x)
    system.fail(dead)
    return getattr(system, op)(v)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", OPS)
def test_device_residues_match_reference(op, kind):
    """The residues the device takes (int64 or int32 rows, as the caller
    holds them) are NumPy's `%`, bitwise, whatever the rows hold."""
    j, t = _pair("rs", 16, 4, None)
    x = payload(kind, 16, W, seed=OPS.index(op))
    v = payload(kind, 20, W, seed=7)
    dead = _pattern(16, 4)
    got, want = _run(t, op, x, v, dead), _run(j, op, x, v, dead)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert t.failed == j.failed


FALLBACK = [np.float64, np.uint16, np.int16, np.uint64, np.bool_, np.str_]


@pytest.mark.parametrize("dtype", FALLBACK, ids=lambda d: d.__name__)
@pytest.mark.parametrize("op", ["codeword", "read", "rebuild"])
def test_other_dtypes_take_the_host_residues(op, dtype):
    """A payload of another dtype is reduced on the host (`on_card` false)
    and gives what its int64 values give, or raises the error NumPy's `%`
    raises for it."""
    from repro_torch.obs import trace

    t = TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu")
    rng = np.random.default_rng(11)
    x64 = rng.integers(0, 2 if dtype is np.bool_ else 5000, (16, W))
    v64 = rng.integers(0, 2 if dtype is np.bool_ else 5000, (20, W))
    x, v = x64.astype(dtype), v64.astype(dtype)
    try:
        x % Q  # NumPy refuses some dtypes (strings; q beyond 16 bits)
    except (TypeError, OverflowError) as err:
        with pytest.raises(type(err), match=re.escape(str(err))):
            _run(t, op, x, v, [1, 19])
        return
    want = _run(t, op, x64, v64, [1, 19])
    with trace.installed() as tracer:
        got = _run(t, op, x, v, [1, 19])
    assert np.array_equal(got, want)
    on_card = [e["args"]["on_card"] for e in tracer.events()
               if e["name"] == "host_in"]
    assert on_card == [False]


@pytest.mark.parametrize("op", OPS)
def test_answers_are_fresh_arrays_the_caller_owns(op):
    t = TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu")
    dead = _pattern(16, 4)
    first = [payload("negatives", r, W, seed=1) for r in (16, 20)]
    second = [payload("int32", r, W, seed=2) for r in (16, 20)]
    a = _run(t, op, *first, dead)
    kept = a.copy()
    b = _run(t, op, *second, dead)
    for ans in (a, b):
        assert ans.dtype == np.int64 and ans.flags.c_contiguous
        assert ans.flags.writeable and ans.flags.owndata
        assert not any(np.shares_memory(ans, p) for p in first + second)
    assert not np.shares_memory(a, b)
    assert np.array_equal(a, kept)          # unchanged by the next call
    b[...] = -1                             # the caller may write its answer
    assert np.array_equal(_run(t, op, *first, dead), kept)


def test_two_threads_share_one_session_for_codewords():
    import threading

    t = TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu")
    xs = [payload(k, 16, W, seed=i) for i, k in enumerate(KINDS)]
    want = [t.codeword(x) for x in xs]
    bad: list = []

    def work(order):
        for _ in range(6):
            for i in order:
                if not np.array_equal(t.codeword(xs[i]), want[i]):
                    bad.append(i)

    n = len(xs)
    threads = [threading.Thread(target=work, args=(order,)) for order in
               (range(n), range(n - 1, -1, -1))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert bad == []


HOLDERS = {"name": lambda a: a, "view": lambda a: a[1:, ::2],
           "view_of_a_view": lambda a: a[1:][:, 3:],
           "tensor": torch.from_numpy, "memoryview": memoryview,
           "frombuffer": lambda a: np.frombuffer(a, np.int64)}


@pytest.mark.parametrize("holder", ["none"] + list(HOLDERS))
def test_held_counts_every_holder_of_a_pooled_array(holder):
    from repro_torch.api.backends import _held

    arrays = [np.empty((4, 6), np.int64)]
    h = HOLDERS[holder](arrays[0]) if holder != "none" else None
    assert _held(arrays, 0) is (h is not None)
    del h
    assert not _held(arrays, 0)


def _reuse_case(t, op, dead, seed, w=W):
    return _run(t, op, payload("negatives", 16, w, seed=seed),
                payload("int32", 20, w, seed=seed + 1), dead)


@pytest.mark.parametrize("case", ["dropped", "name", "view", "tensor",
                                  "shapes"])
@pytest.mark.parametrize("op", ["codeword", "read", "rebuild"])
def test_answers_come_from_pages_the_caller_let_go(op, case):
    """An answer the caller let go is handed out again (`host_out`'s
    `reused`), bitwise the JAX package's answer; one the caller, a view or
    a tensor of it holds never is, and the caller's writes into it stay;
    across many shapes the pool keeps within its bound."""
    from repro_torch.api.backends import ANSWERS, AnswerPool
    from repro_torch.obs import trace

    j, t = _pair("rs", 16, 4, None)
    dead = _pattern(16, 4)
    if case == "shapes":
        kept = []
        for w in range(1, 3 * AnswerPool.SHAPES + 1):
            for n in range(3):
                a = _reuse_case(t, op, dead, n, w)
                kept.append((a, a.copy()))
                tracked = ANSWERS.tracked()
                assert len(tracked) <= AnswerPool.SHAPES
                assert max(tracked.values()) <= AnswerPool.PER_SHAPE
            _reuse_case(t, op, dead, 9, w)  # let go at once
        for i, (a, copy) in enumerate(kept):
            assert np.array_equal(a, copy)
            assert not any(np.shares_memory(a, b) for b, _ in kept[i + 1:])
        return
    a = _reuse_case(t, op, dead, 1)
    ptr = a.ctypes.data
    holder = HOLDERS[case](a) if case != "dropped" else None
    if holder is not None:
        holder[...] = -5  # the caller writes into its answer
    del a
    with trace.installed() as tracer:
        b = _reuse_case(t, op, dead, 2)
    reused = [e["args"]["reused"] for e in tracer.events()
              if e["name"] == "host_out"]
    assert np.array_equal(b, _reuse_case(j, op, dead, 2))
    assert b.flags.owndata and b.flags.writeable and b.flags.c_contiguous
    if holder is None:
        assert b.ctypes.data == ptr and reused == [True]
        return
    assert b.ctypes.data != ptr and len(reused) == 1
    held = holder.numpy() if case == "tensor" else holder
    assert not np.shares_memory(b, held)
    assert (held == -5).all()


def test_two_threads_never_share_a_live_answer():
    """Two threads on one session, each holding its last two answers while
    it asks for the next: no answer handed out shares memory with one that
    is live, and none of the live ones changes."""
    import threading

    t = TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu")
    xs = [payload(k, 16, W, seed=i) for i, k in enumerate(KINDS)]
    want = [t.codeword(x) for x in xs]
    live: dict = {}
    lock = threading.Lock()
    bad: list = []

    def work(k, order):
        for step in range(40):
            i = order[step % len(order)]
            got = t.codeword(xs[i])
            with lock:
                if any(np.shares_memory(got, a) for a, _ in live.values()):
                    bad.append(("shared", k, step))
                if any(not np.array_equal(a, want[n])
                       for a, n in live.values()):
                    bad.append(("changed", k, step))
                live[(k, step % 2)] = (got, i)
            del got

    n = len(xs)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k, order))
                   for k, order in enumerate((list(range(n)),
                                              list(range(n - 1, -1, -1))))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert bad == []


def test_explicit_matrix_matches_reference():
    """A universal spec may take the reference's matrix as a numpy A."""
    A = np.random.default_rng(9).integers(0, Q, (10, 5))
    j = JSystem(JSpec(kind="universal", K=10, R=5), backend="local", A=A)
    t = TSystem(TSpec(kind="universal", K=10, R=5), backend="local", A=A,
                device="cpu")
    x = np.random.default_rng(10).integers(0, Q, (10, W))
    cw = t.codeword(x)
    assert np.array_equal(cw, j.codeword(x))
    for sys_ in (j, t):
        sys_.fail([0, 3, 11])
    assert np.array_equal(t.read(cw), j.read(cw))
    assert np.array_equal(t.rebuild(cw), j.rebuild(cw))


def test_dft_above_4096_codeword_matches_reference():
    """A dft K=8192 codeword: the port's NTT takes every Z the JAX package
    takes (Z | q - 1), not only Z <= 4096."""
    j, t = _pair("dft", 8192, 8192, None)
    assert t.encode_plan.local_impl == j.encode_plan.local_impl == "ntt"
    x = np.random.default_rng(8192).integers(0, Q, (8192, 16))
    x[:, 0] = Q - 1
    cw = t.codeword(x)
    assert cw.shape == (16384, 16)
    assert np.array_equal(cw, j.codeword(x))


DFT16_UNDECODABLE = (0, 2, 4, 6, 8, 10, 12, 14, 16, 17)


def test_dft_undecodable_pattern_raises_like_reference():
    j, t = _pair("dft", 16, 16, None)
    for sys_ in (j, t):
        sys_.fail(DFT16_UNDECODABLE)
    with pytest.raises(JUndecodable) as jerr:
        j.decode_plan
    with pytest.raises(UndecodableError) as terr:
        t.decode_plan
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(UndecodableError):
        Decoder.plan(TSpec(kind="dft", K=16, R=16), DFT16_UNDECODABLE,
                     device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.api import Encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TSpec(kind="rs", K=16, R=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSystem(spec, backend="local")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Encoder.plan(spec, backend="local")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder.plan(spec, erased=(1,))
    assert TSystem(spec, backend="local", device="cpu").device.type == "cpu"


def test_plans_are_cached_per_device():
    from repro_torch.api import Encoder

    spec = TSpec(kind="rs", K=16, R=4)
    p = Encoder.plan(spec, device="cpu")
    assert Encoder.plan(spec, device=torch.device("cpu")) is p
    assert Decoder.plan(spec, (1,), device="cpu") is Decoder.plan(
        spec, (1,), device="cpu")
    assert p.device == torch.device("cpu")


# ---------------- import isolation ---------------------------------------------

def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch.api, repro_torch.recover, "
            "repro_torch.kernels, repro_torch.launch, repro_torch.core, "
            "repro_torch.ckpt, repro_torch.coding, "
            "repro_torch.launch.service, repro_torch.launch.serve, "
            "repro_torch.configs, repro_torch.models.convert, "
            "repro_torch.train.serve, repro_torch.optim, repro_torch.data, "
            "repro_torch.train, repro_torch.launch.train, repro_torch.dist, "
            "repro_torch.launch.mesh, repro_torch.launch.hlo_cost, "
            "repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    scanned = {p.relative_to(ROOT).as_posix() for p in files}
    assert {"src/repro_torch/launch/coding_queue.py",
            "src/repro_torch/api/stream.py",
            "src/repro_torch/core/schedule.py",
            "src/repro_torch/ckpt/checkpoint.py",
            "src/repro_torch/coding/gradient_code.py",
            "src/repro_torch/launch/service.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/models/model.py",
            "src/repro_torch/configs/qwen3_1_7b.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/train/state.py",
            "src/repro_torch/train/train_loop.py",
            "src/repro_torch/train/coded_step.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/dist/sharding.py",
            "src/repro_torch/dist/ctx.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/hlo_cost.py",
            "src/repro_torch/launch/dryrun.py"} <= scanned
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


NAMED = re.compile(r'backend\s*(==|!=)\s*"(local|mesh|simulator)"')


def test_port_sources_never_ask_which_backend_they_run_on():
    """Only the backends' own modules may name a built-in backend in a
    comparison: the session, the planners and the queue ask the `Backend`."""
    owners = {"src/repro_torch/api/backends.py",
              "src/repro_torch/recover/backends.py"}
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert {"src/repro_torch/api/system.py", "src/repro_torch/api/planner.py",
            "src/repro_torch/recover/planner.py"} <= {
                p.relative_to(ROOT).as_posix() for p in files}
    named = [(p.relative_to(ROOT).as_posix(), n) for p in files
             for n, line in enumerate(p.read_text().splitlines(), 1)
             if NAMED.search(line)
             and p.relative_to(ROOT).as_posix() not in owners]
    assert named == []


class _EncodeDecodeOnly(Backend):
    """A third-party backend with `encode` and `decode` alone (the
    simulator's executors): the session lays its answers out through
    `Backend.run_into`'s default and the host's layout."""

    host_only = True

    def encode(self, plan, x):
        from repro_torch.api.backends import run_simulator

        return run_simulator(plan, x)[0]

    def decode(self, plan, v):
        from repro_torch.recover.backends import run_simulator

        return run_simulator(plan, v)[0]


def _rebuilt(system, op, lost, v):
    if op == "rebuild_n":
        return system.rebuild(lost)
    if op == "rebuild_k":
        return system.rebuild(v)
    if op == "rebuild_stream":
        return np.concatenate(list(system.rebuild_stream(lost, chunk_w=16)),
                              axis=1)
    return system.submit("rebuild", lost).result(timeout=120)


@pytest.mark.parametrize("op", ["codeword", "rebuild_n", "rebuild_k",
                                "rebuild_stream", "submit_rebuild"])
def test_third_party_backend_lays_out_on_the_host(op):
    register_backend("encode-decode-only", _EncodeDecodeOnly)
    j = JSystem(JSpec(kind="rs", K=16, R=4), backend="simulator")
    t = TSystem(TSpec(kind="rs", K=16, R=4), backend="encode-decode-only")
    try:
        rng = np.random.default_rng(29)
        x = payload("negatives", 16, W, seed=29)
        cw = j.codeword(x)
        if op == "codeword":
            got, want = t.codeword(x), cw
        else:
            for sys_ in (j, t):
                sys_.fail(_pattern(16, 4))
            lost = cw + Q * rng.integers(-3, 4, cw.shape)  # not residues
            lost[list(t.failed)] = 0
            v = lost[list(t.kept)]
            got, want = _rebuilt(t, op, lost, v), _rebuilt(j, op, lost, v)
            assert np.array_equal(got, cw)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    finally:
        t.close()
        j.close()
        unregister_backend("encode-decode-only")


def test_trace_splits_each_op_into_host_copy_and_kernel_spans():
    from repro_torch.api import cache_clear
    from repro_torch.obs.trace import Tracer

    cache_clear()  # the decode plan is made here, not found in the cache
    tracer = Tracer()
    with TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu",
                 trace=tracer) as t:
        x = np.random.default_rng(3).integers(0, Q, (16, W))
        cw = t.codeword(x)
        t.fail([2, 17])
        t.read(cw)
    tracks = {e["args"]["name"]: e["pid"]
              for e in tracer.to_dict()["traceEvents"]
              if e["name"] == "process_name"}
    legs = [e for e in tracer.events() if e["pid"] == tracks["backend"]]
    assert [e["name"] for e in legs] == [
        "host_in", "h2d", "residues_dev", "local_encode.ntt", "place_dev",
        "d2h", "host_out",
        "host_in", "h2d", "residues_dev", "local_data", "d2h", "host_out"]
    assert all(e["cat"] == "kernel" for e in legs)
    assert all(e["args"]["on_card"] for e in legs if e["name"] == "host_in")
    assert all(type(e["args"]["reused"]) is bool for e in legs
               if e["name"] == "host_out")
    # the session's and the planner's host steps sit between the legs
    names = [(e["name"], {v: k for k, v in tracks.items()}[e["pid"]])
             for e in tracer.events()]
    session = [("assemble", "session"), ("host_in", "backend"),
               ("h2d", "backend"), ("residues_dev", "backend"),
               ("local_encode.ntt", "backend"), ("place_dev", "backend"),
               ("d2h", "backend"), ("host_out", "backend")]
    planner = [("kept", "planner"), ("inverse", "planner"),
               ("repair", "planner"), ("plan", "planner")]
    read = [("assemble", "session"), ("host_in", "backend"),
            ("h2d", "backend"), ("residues_dev", "backend"),
            ("local_data", "backend"), ("d2h", "backend"),
            ("host_out", "backend")]
    assert names == session + planner + read
    plan = next(e for e in tracer.events() if e["name"] == "plan")
    assert plan["args"]["erased"] == 2 and plan["args"]["hit"] is False
    assert all(e["args"]["minflt"] >= 0 for e in tracer.events())


def test_kernel_build_needs_nvcc_and_keys_on_the_source(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == len(build.SOURCES) == 3
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert build.library_path("ntt") == build.library_path("ntt")
