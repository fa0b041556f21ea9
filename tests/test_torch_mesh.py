"""The port's mesh backend against the JAX package, bitwise, on the CPU, in
one process (G = 1 rank holding every processor; `device="cpu"`: the
batched `gf_matmul`'s plain version).

The JAX package's own mesh runs in subprocesses with forced host devices
(`tests/*_mesh_checks.py`); its simulator is pure numpy and runs here, so
every scenario of those scripts is held against `repro`'s simulator on the
same seeded inputs.  The host tables are compared array for array.  All
arithmetic is exact in F_65537: there is no tolerance."""
import numpy as np
import pytest
import torch

import repro.core.shardmap_exec as jse
from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.api import Encoder as JEncoder
from repro.api import Topology as JTopology
from repro.core.field import FERMAT as JFERMAT
from repro.core.parity import build_parity_tables as j_build_parity_tables
from repro.recover import Decoder as JDecoder
from repro.topo import place as j_place
from repro_torch.api import BackendCapabilityError, CodedSystem, CodeSpec
from repro_torch.api import Encoder, Topology, available_backends
from repro_torch.coding import CodedMatmul, LagrangeComputer
from repro_torch.core import shardmap_exec as se
from repro_torch.core.field import FERMAT
from repro_torch.core.matrices import permuted_dft_matrix
from repro_torch.core.parity import build_parity_tables, mesh_parity_encode
from repro_torch.kernels import (gf_matmul_batched, gf_matmul_batched_plain,
                                 gf_matmul_plain)
from repro_torch.recover import Decoder
from repro_torch.recover.backends import _mesh_callables
from repro_torch.topo import place

torch.set_num_threads(1)

Q = 65537
CPU = "cpu"
f = FERMAT


def _spec_pair(kind, K, R, W=16, seed=None, **kw):
    return (JSpec(kind=kind, K=K, R=R, W=W, seed=seed, **kw),
            CodeSpec(kind=kind, K=K, R=R, W=W, seed=seed, **kw))


def _block(x):
    return torch.as_tensor(np.asarray(x) % Q, dtype=torch.int32)


# ---------------------------------------------------------------------------
# host tables: equal to repro's array for array
# ---------------------------------------------------------------------------

def _same_fields(a, b):
    for name in a.__dataclass_fields__:
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), name
        elif va is None or isinstance(va, (int, bool, str)):
            assert va == vb, name


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("grouped", [False, True])
def test_universal_tables_match_reference(p, grouped):
    rng = np.random.default_rng(5 + p)
    mats = ([f.rand((4, 4), rng), f.rand((4, 4), rng)] if grouped
            else [f.rand((8, 8), rng)])
    _same_fields(jse.build_universal_tables(JFERMAT, mats, 8, p=p),
                 se.build_universal_tables(f, mats, 8, p=p))


@pytest.mark.parametrize("inverse", [False, True])
def test_dft_tables_match_reference(inverse):
    _same_fields(jse.build_dft_tables(JFERMAT, 16, 8, inverse=inverse),
                 se.build_dft_tables(f, 16, 8, inverse=inverse))


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("method", ["universal", "rs"])
def test_parity_tables_match_reference(R, method):
    jt = j_build_parity_tables(JFERMAT, 8, R, p=1, method=method)
    tt = build_parity_tables(f, 8, R, p=1, method=method)
    ja, ta = jt.device_arrays(), tt.device_arrays()
    assert list(ja) == list(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and np.array_equal(ja[k], ta[k]), k


def test_decode_mesh_tables_match_reference():
    js, ts = _spec_pair("rs", 16, 8)
    erased = (1, 5, 17, 20, 22)
    jp = JDecoder.plan(js, erased=erased, backend="simulator")
    tp = Decoder.plan(ts, erased=erased, backend="mesh", device=CPU)
    assert jp.tables.batches() == tp.tables.batches()
    for b in range(len(tp.tables.batches())):
        ja = jp.tables.mesh_tables(b).device_arrays()
        ta = tp.tables.mesh_tables(b).device_arrays()
        assert list(ja) == list(ta)
        for k in ja:
            assert np.array_equal(ja[k], ta[k]), (b, k)


def test_ir_mesh_program_matches_reference():
    js, ts = _spec_pair("rs", 16, 4)
    jplan = JEncoder.plan(js, backend="simulator",
                          topology=j_place(js, JTopology(5, 4), "affinity"),
                          commute=True)
    tplan = Encoder.plan(ts, backend="simulator",
                         topology=place(ts, Topology(5, 4), "affinity"),
                         commute=True)
    assert jplan.schedule_ir().digest() == tplan.schedule_ir().digest()
    dev_of = list(range(16)) + list(range(4))
    jp = jse.build_ir_mesh_program(jplan.schedule_ir(), dev_of)
    tp = se.build_ir_mesh_program(tplan.schedule_ir(), dev_of)
    assert (jp.n_dev, jp.n_slots) == (tp.n_dev, tp.n_slots)
    assert np.array_equal(jp.init_slot, tp.init_slot)
    assert np.array_equal(jp.out_slot, tp.out_slot)
    assert len(jp.rounds) == len(tp.rounds)
    n_legs = 0
    for (jl, jy), (tl, ty) in zip(jp.rounds, tp.rounds):
        assert len(jl) == len(tl) and len(jy) == len(ty)
        for a, b in zip(jl, tl):
            assert a.perm == b.perm
            assert np.array_equal(a.gather, b.gather)
            assert np.array_equal(a.scatter, b.scatter)
            n_legs += 1
        for a, b in zip(jy, ty):
            assert np.array_equal(a.out_idx, b.out_idx)
            assert np.array_equal(a.coeff, b.coeff)
            assert np.array_equal(a.term, b.term)
    assert n_legs > 0
    ja, ta = jp.device_arrays(), tp.device_arrays()
    assert list(ja) == list(ta)


# ---------------------------------------------------------------------------
# the bodies against the oracles of tests/mesh_checks.py
# ---------------------------------------------------------------------------

def _oracle_x(seed=123, N=8, W=16):
    return f.rand((N, W), np.random.default_rng(seed))


@pytest.mark.parametrize("p", [1, 2])
def test_universal_body_matches_oracle(p):
    rng = np.random.default_rng(40 + p)
    x = _oracle_x()
    C = f.rand((8, 8), rng)
    mesh = se.ProcMesh(8, CPU)
    t = se.build_universal_tables(f, [C], 8, p=p)
    y = se.mesh_universal_a2a(_block(x), se.universal_rows(t, mesh), t, mesh)
    assert np.array_equal(y.numpy(), f.matmul(C.T, x))


def test_grouped_universal_body_matches_oracle():
    rng = np.random.default_rng(44)
    x = _oracle_x()
    C0, C1 = f.rand((4, 4), rng), f.rand((4, 4), rng)
    mesh = se.ProcMesh(8, CPU)
    t = se.build_universal_tables(f, [C0, C1], 8, p=1)
    y = se.mesh_universal_a2a(_block(x), se.universal_rows(t, mesh), t, mesh)
    want = np.concatenate([f.matmul(C0.T, x[:4]), f.matmul(C1.T, x[4:])])
    assert np.array_equal(y.numpy(), want)


def test_dft_body_forward_and_inverse():
    x = _oracle_x()
    mesh = se.ProcMesh(8, CPU)
    td = se.build_dft_tables(f, 8, 8)
    y = se.mesh_dft(_block(x), mesh.rows(td.ca.T), mesh.rows(td.cb.T), td,
                    mesh)
    D = permuted_dft_matrix(f, 8, 2)
    assert np.array_equal(y.numpy(), f.matmul(D.T, x))
    ti = se.build_dft_tables(f, 8, 8, inverse=True)
    back = se.mesh_dft(y, mesh.rows(ti.ca.T), mesh.rows(ti.cb.T), ti, mesh,
                       inverse=True)
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("R", [2, 4, 8])
@pytest.mark.parametrize("method", ["universal", "rs"])
def test_parity_body_matches_oracle(R, method):
    x = _oracle_x()
    mesh = se.ProcMesh(8, CPU)
    t = build_parity_tables(f, 8, R, p=1, method=method)
    y = mesh_parity_encode(_block(x), t.device_rows(mesh), t, mesh)
    A = t.sgrs.grs.A_direct()
    assert np.array_equal(y.numpy()[:R], f.matmul(A.T, x))
    assert mesh.legs["flat"] > 0 and mesh.cross_rank == 0


@pytest.mark.parametrize("inverse", [False, True])
def test_draw_loose_body_matches_vandermonde(inverse):
    from repro_torch.core.matrices import (StructuredPoints, gauss_inverse,
                                           vandermonde)

    sp = StructuredPoints.build(f, 16, max_h=2)          # M = 4, Z = 4
    assert (sp.M, sp.Z) == (4, 4)
    jt = jse.build_draw_loose_tables(JFERMAT, sp, 16, 1, inverse=inverse)
    t = se.build_draw_loose_tables(f, sp, 16, 1, inverse=inverse)
    _same_fields(jt.univ, t.univ)
    _same_fields(jt.dft, t.dft)
    assert np.array_equal(jt.scale, t.scale)
    x = _oracle_x(N=16)
    mesh = se.ProcMesh(16, CPU)
    y = se.mesh_draw_loose(_block(x), t, se.draw_loose_rows(t, mesh), mesh)
    V = vandermonde(f, sp.points())      # V[k, c] = point_c^k
    if inverse:
        V = gauss_inverse(f, V)
    assert np.array_equal(y.numpy(), f.matmul(V.T, x))


def test_permute_zero_fills_processors_that_receive_nothing():
    mesh = se.ProcMesh(4, CPU)
    x = torch.arange(1, 13, dtype=torch.int32).reshape(4, 3)
    y = mesh.ppermute(x, "partial", [(0, 2), (3, 1)])
    assert torch.equal(y, torch.stack([torch.zeros(3, dtype=torch.int32),
                                       x[3], x[0],
                                       torch.zeros(3, dtype=torch.int32)]))
    # the compiled permutation is cached by its key
    assert mesh.ppermute(x, "partial", None).equal(y)
    assert mesh.legs["flat"] == 2


# ---------------------------------------------------------------------------
# tests/api_mesh_checks.py
# ---------------------------------------------------------------------------

API_CASES = [
    ("universal", 8, 4, ["auto", "universal"]),
    ("universal", 8, 8, ["auto"]),
    ("rs", 8, 4, ["auto", "universal", "rs"]),
    ("rs", 8, 8, ["universal", "rs"]),
    ("rs", 8, 2, ["universal", "rs"]),
    ("lagrange", 8, 4, ["auto", "universal", "rs"]),
    ("dft", 8, 8, ["auto"]),
]


@pytest.mark.parametrize("kind,K,R,methods", API_CASES)
def test_mesh_encode_matches_reference_simulator(kind, K, R, methods):
    rng = np.random.default_rng(42 + K + R)
    js, ts = _spec_pair(kind, K, R, seed=9 if kind == "universal" else None)
    x = f.rand((K, 16), rng)
    for method in methods:
        jp = JEncoder.plan(js, backend="simulator", method=method)
        tp = Encoder.plan(ts, backend="mesh", method=method, device=CPU)
        assert tp.method == jp.method
        assert np.array_equal(tp.run(x), jp.run(x)), (kind, method)
        assert np.array_equal(tp.run(x[:, 3]), jp.run(x[:, 3]))


def test_mesh_plan_and_callable_are_cached():
    assert "mesh" in available_backends()
    spec = CodeSpec(kind="rs", K=8, R=4, W=16)
    p1 = Encoder.plan(spec, backend="mesh", device=CPU)
    fn1 = p1.mesh_callable()
    p2 = Encoder.plan(spec, backend="mesh", device=CPU)
    assert p2 is p1 and p2.mesh_callable() is fn1
    assert "G=1 ranks x 8 processors" in p1.describe()
    with pytest.raises(ValueError):
        Encoder.plan(spec, backend="local", device=CPU).mesh_callable()


def test_mesh_explicit_matrix_universal():
    rng = np.random.default_rng(43)
    A = f.rand((8, 4), rng)
    x = f.rand((8, 16), rng)
    js, ts = _spec_pair("universal", 8, 4)
    want = JEncoder.plan(js, backend="simulator", A=A).run(x)
    assert np.array_equal(
        Encoder.plan(ts, backend="mesh", A=A, device=CPU).run(x), want)


# ---------------------------------------------------------------------------
# tests/recover_mesh_checks.py
# ---------------------------------------------------------------------------

RECOVER_CASES = [
    ("universal", 8, 4, [(3,), (0, 9), (0, 1, 2, 3), (8, 9, 10, 11)]),
    ("rs", 8, 4, [(2, 11), (4, 5, 6, 7), (0, 3, 8, 10)]),
    ("rs", 8, 8, [(0, 2, 4, 6, 8, 10, 12, 14), tuple(range(8))]),
    ("lagrange", 8, 4, [(1, 10, 11)]),
    ("dft", 8, 8, [(0,), (5, 9, 13)]),
]


@pytest.mark.parametrize("kind,K,R,patterns", RECOVER_CASES)
def test_mesh_decode_matches_reference_simulator(kind, K, R, patterns):
    rng = np.random.default_rng(12 + K + R)
    js, ts = _spec_pair(kind, K, R, seed=9 if kind == "universal" else None)
    x = f.rand((K, 16), rng)
    cw = np.concatenate([x % Q, JEncoder.plan(js, backend="simulator").run(x)])
    for erased in patterns:
        jp = JDecoder.plan(js, erased=erased, backend="simulator")
        tp = Decoder.plan(ts, erased=erased, backend="mesh", device=CPU)
        assert tp.kept == jp.kept
        v = cw[list(tp.kept)]
        got = tp.run(v)
        assert np.array_equal(got, jp.run(v)), (kind, erased)
        assert np.array_equal(got, cw[list(erased)]), (kind, erased)


def test_mesh_decode_plan_and_callables_are_cached():
    spec = CodeSpec(kind="rs", K=8, R=4, W=16)
    p1 = Decoder.plan(spec, erased=(0, 9), backend="mesh", device=CPU)
    fns = _mesh_callables(p1)
    p2 = Decoder.plan(spec, erased=(9, 0), backend="mesh", device=CPU)
    assert p2 is p1 and _mesh_callables(p2) is fns


def test_degraded_checkpoint_restore(tmp_path):
    from repro_torch.ckpt import CodedCheckpointer

    state = {"w": np.arange(4096, dtype=np.float32).reshape(64, 64),
             "s": np.float32(3.25)}
    ck = CodedCheckpointer(str(tmp_path), n_shards=8, n_parity=2, device=CPU)
    ck.save(5, state)
    for name in ("shard_002.npy", "shard_004.npy"):
        (tmp_path / "step_000005" / name).unlink()
    rest = ck.restore(5, state)
    assert np.array_equal(np.asarray(rest["w"]), state["w"])
    assert np.asarray(rest["s"]) == state["s"]


# ---------------------------------------------------------------------------
# tests/system_mesh_checks.py
# ---------------------------------------------------------------------------

SYSTEM_CASES = [
    ("universal", 8, 4, (0, 9)),
    ("rs", 8, 4, (2, 4, 11)),
    ("rs", 8, 8, (0, 2, 9, 13)),
    ("lagrange", 8, 4, (1, 10)),
    ("dft", 8, 8, (5, 9, 13)),
]


@pytest.mark.parametrize("kind,K,R,erased", SYSTEM_CASES)
def test_mesh_session_round_trip_matches_reference(kind, K, R, erased):
    rng = np.random.default_rng(31 + K + R)
    js, ts = _spec_pair(kind, K, R, seed=9 if kind == "universal" else None)
    x = rng.integers(0, Q, (K, 16))
    ref = JSystem(js, backend="simulator")
    jcw = ref.codeword(x)
    ref.fail(erased)
    jlost, jdata = ref.decode(jcw), ref.read(jcw)

    system = CodedSystem(ts, backend="mesh", device=CPU)
    cw = system.codeword(x)
    assert np.array_equal(cw, jcw)
    system.fail(erased)
    assert np.array_equal(system.decode(cw), jlost)
    assert np.array_equal(system.read(cw), jdata)
    assert np.array_equal(jdata, x % Q)
    system.heal()
    assert np.array_equal(system.encode(x), cw[K:])
    system.fail(erased)
    assert np.array_equal(system.rebuild(cw), cw)
    assert system.failed == ()
    system.fail(erased)
    assert np.array_equal(system.rebuild(cw[list(system.kept)]), cw)
    system.fail(erased)
    streamed = np.concatenate(list(system.rebuild_stream(cw, chunk_w=8)),
                              axis=1)
    assert np.array_equal(streamed, cw)
    assert system.failed == ()
    system.close()


# ---------------------------------------------------------------------------
# tests/stream_mesh_checks.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,K,R", [("rs", 8, 4), ("dft", 8, 8)])
def test_mesh_encode_stream_and_batched(kind, K, R):
    rng = np.random.default_rng(21 + K + R)
    js, ts = _spec_pair(kind, K, R, W=150)
    x = f.rand((K, 150), rng)
    ref = JEncoder.plan(js, backend="simulator").run(x)
    mesh = Encoder.plan(ts, backend="mesh", device=CPU)
    got = np.concatenate(list(mesh.run_stream(x, chunk_w=64)), axis=1)
    assert np.array_equal(ref, got)
    outs = mesh.run_batched([x[:, :13], x[:, 13], x[:, 14:]])
    assert np.array_equal(outs[0], ref[:, :13])
    assert np.array_equal(outs[1], ref[:, 13])
    assert np.array_equal(outs[2], ref[:, 14:])


@pytest.mark.parametrize("erased", [(0, 9), (1, 2, 3), (4, 8, 10, 11)])
def test_mesh_decode_stream_and_batched(erased):
    rng = np.random.default_rng(22)
    js, ts = _spec_pair("rs", 8, 4, W=150)
    x = f.rand((8, 150), rng)
    cw = np.concatenate([x % Q, JEncoder.plan(js, backend="simulator").run(x)])
    jd = JDecoder.plan(js, erased=erased, backend="simulator")
    v = cw[list(jd.kept)]
    ref = jd.run(v)
    d = Decoder.plan(ts, erased=erased, backend="mesh", device=CPU)
    got = np.concatenate(list(d.run_stream(v, chunk_w=64)), axis=1)
    assert np.array_equal(ref, got)
    outs = d.run_batched([v[:, :50], v[:, 50:]])
    assert np.array_equal(np.concatenate(outs, axis=1), ref)


# ---------------------------------------------------------------------------
# tests/schedule_mesh_checks.py: the generic IR lowering (commute=True)
# ---------------------------------------------------------------------------

SCHEDULE_CASES = [  # (kind, K, R, p, (hosts, dph), method, W, fired)
    ("rs", 16, 4, 1, (5, 4), "auto", 3, True),
    ("rs", 16, 4, 2, (5, 4), "auto", 3, True),
    ("lagrange", 16, 4, 1, (5, 4), "auto", 3, True),
    ("rs", 16, 4, 1, (5, 4), "universal", 3, True),
    ("rs", 16, 4, 1, (4, 5), "auto", 3, False),
    ("rs", 16, 4, 1, (4, 5), "universal", 1, False),
]


@pytest.mark.parametrize("kind,K,R,p,topo,method,W,fired", SCHEDULE_CASES)
def test_commuted_mesh_plan_matches_reference_simulator(kind, K, R, p, topo,
                                                        method, W, fired):
    rng = np.random.default_rng(7 + K + p + W)
    js, ts = _spec_pair(kind, K, R, p=p)
    jsim = JEncoder.plan(js, backend="simulator", method=method,
                         topology=j_place(js, JTopology(*topo), "affinity"),
                         commute=True)
    mesh = Encoder.plan(ts, backend="mesh", method=method,
                        topology=place(ts, Topology(*topo), "affinity"),
                        commute=True, device=CPU)
    assert mesh.schedule_ir().digest() == jsim.schedule_ir().digest()
    x = rng.integers(0, Q, (K, W), dtype=np.int64)
    assert np.array_equal(mesh.run(x), jsim.run(x))
    assert fired == any(r.tag.startswith("commute")
                        for r in mesh.schedule_ir().rounds)
    assert sum(mesh.mesh_callable().mesh.legs.values()) > 0


def test_table_path_and_ir_path_agree_on_a_tiered_plan():
    spec = CodeSpec("rs", 16, 4)
    pl = place(spec, Topology(4, 5), "affinity")
    x = np.random.default_rng(8).integers(0, Q, (16, 3), dtype=np.int64)
    y_tab = Encoder.plan(spec, backend="mesh", topology=pl, device=CPU).run(x)
    y_ir = Encoder.plan(spec, backend="mesh", topology=pl, commute=True,
                        device=CPU).run(x)
    assert np.array_equal(y_tab, y_ir)


# ---------------------------------------------------------------------------
# tests/topo_mesh_checks.py: tiered plans, and the legs per tier
# ---------------------------------------------------------------------------

TOPO_SPECS = [("universal", 8, 4, 3), ("rs", 8, 4, None),
              ("lagrange", 8, 4, None), ("dft", 8, 8, None)]


@pytest.mark.parametrize("kind,K,R,seed", TOPO_SPECS)
def test_tiered_mesh_plans_match_flat_and_reference(kind, K, R, seed):
    rng = np.random.default_rng(23 + K + R)
    js, ts = _spec_pair(kind, K, R, W=32, seed=seed)
    x = f.rand((K, 32), rng)
    flat_plan = Encoder.plan(ts, backend="mesh", device=CPU)
    flat = flat_plan.run(x)
    assert np.array_equal(flat, JEncoder.plan(js, backend="simulator").run(x))
    assert set(flat_plan.mesh_callable().mesh.legs) == {"flat"}
    for hosts, dph in ((2, 4), (4, 2)):
        plan = Encoder.plan(ts, backend="mesh", topology=Topology(hosts, dph),
                            device=CPU)
        assert plan is not flat_plan
        assert np.array_equal(plan.run(x), flat)
        assert Encoder.plan(ts, backend="mesh", topology=Topology(hosts, dph),
                            device=CPU) is plan


def _reference_tier(perm, hosts, dph):
    """The axis the reference's `_tiered_ppermute` lowers `perm` onto,
    read by standing in for `jax.lax.ppermute`."""
    import jax

    seen = []
    orig = jax.lax.ppermute
    jax.lax.ppermute = lambda x, axis, perm: seen.append(axis)
    try:
        jse._tiered_ppermute(None, jse.TieredAxis(hosts, dph), list(perm))
    finally:
        jax.lax.ppermute = orig
    return {"dev": "dev", "host": "host"}.get(seen[0], "joint")


@pytest.mark.parametrize("kind,K,R", [("rs", 8, 4), ("dft", 8, 8)])
@pytest.mark.parametrize("hosts,dph", [(2, 4), (4, 2)])
def test_tier_counters_follow_the_reference_lowering(kind, K, R, hosts, dph):
    spec = CodeSpec(kind, K, R, W=8)
    x = f.rand((K, 8), np.random.default_rng(24))
    plan = Encoder.plan(spec, backend="mesh", topology=Topology(hosts, dph),
                        device=CPU)
    plan.run(x)
    mesh = plan.mesh_callable().mesh
    assert mesh.tiered == se.TieredAxis(hosts, dph)
    runs = sum(mesh.legs.values())
    for op in mesh._perms.values():
        assert op.tier == _reference_tier(op.perm, hosts, dph), op.perm
    if kind == "dft" or (hosts, dph) == (2, 4):
        assert mesh.legs["dev"] > 0 and mesh.legs["host"] > 0, mesh.legs
        assert mesh.legs["joint"] == 0, mesh.legs
    else:
        # rs 8/4 runs universal columns of 4 over hosts of 2: the shift
        # within a column changes host and position at once, which the
        # reference lowers as one joint permute too (checked above)
        assert dict(mesh.legs) == {"host": 2, "joint": 1}, mesh.legs
    plan.run(x)
    assert sum(mesh.legs.values()) == 2 * runs
    assert "legs run so far by tier" in plan.describe()


# ---------------------------------------------------------------------------
# tests/coded_mesh_checks.py
# ---------------------------------------------------------------------------

def test_coded_matmul_on_the_mesh():
    rng = np.random.default_rng(7)
    K, R, b, d, out = 8, 4, 2, 16, 6
    X = f.rand((K * b, d), rng)
    Wm = f.rand((d, out), rng)
    truth = f.matmul(X, Wm)
    cm = CodedMatmul(K, R, backend="mesh", device=CPU)
    shards = cm.encode(X)
    assert np.array_equal(shards[:K].reshape(K * b, d), X % Q)
    results = cm.worker_compute(shards, Wm)
    for nd in range(R + 1):
        patterns = [rng.choice(K + R, size=nd, replace=False)
                    for _ in range(3)]
        if nd == R:
            patterns += [np.arange(R), np.arange(K - R, K)]
        for dead in patterns:
            assert np.array_equal(cm.decode(results, dead=dead), truth), \
                (nd, sorted(dead))
            assert not cm.system.failed
    cm.close()


def test_lagrange_degree_two_decode_on_the_mesh():
    rng = np.random.default_rng(8)
    lcc = LagrangeComputer.build(f, K=4, N=12, device=CPU)
    x = f.rand((4, 5), rng)
    res = f.add(f.mul(lcc.encode(x), lcc.encode(x)), 3)
    want = f.add(f.mul(x % Q, x % Q), 3)
    T = lcc.recovery_threshold(2)
    spec, A = lcc._decode_spec(2)
    ids = np.sort(rng.choice(12, size=T + 2, replace=False))
    live = set(int(w) for w in ids)
    erased = tuple(range(4)) + tuple(4 + n for n in range(12)
                                     if n not in live)
    plan = Decoder.plan(spec, erased, backend="mesh", A=A, device=CPU)
    v = np.stack([res[pos - 4] for pos in plan.kept])
    dec = plan.run(v)[:4]
    assert np.array_equal(dec, want)
    assert np.array_equal(dec, lcc.decode(2, ids, res[ids]))


# ---------------------------------------------------------------------------
# plan-time errors
# ---------------------------------------------------------------------------

def test_mesh_refuses_k_not_divisible_by_ranks(monkeypatch):
    monkeypatch.setattr(se, "world", lambda: (3, 0))
    with pytest.raises(BackendCapabilityError, match="ranks"):
        CodedSystem(CodeSpec(kind="rs", K=8, R=4), backend="mesh", device=CPU)
    with pytest.raises(BackendCapabilityError, match="ranks"):
        Decoder.plan(CodeSpec(kind="rs", K=8, R=4), erased=(1,),
                     backend="mesh", device=CPU)


def test_mesh_refuses_r_not_dividing_k():
    with pytest.raises(BackendCapabilityError, match="R | K"):
        Encoder.plan(CodeSpec(kind="rs", K=12, R=8), backend="mesh",
                     device=CPU)


def test_mesh_refuses_other_fields():
    with pytest.raises(BackendCapabilityError, match="q=257"):
        Encoder.plan(CodeSpec(kind="rs", K=8, R=4, q=257), backend="mesh",
                     device=CPU)


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Encoder.plan(CodeSpec(kind="rs", K=8, R=4), backend="mesh")


# ---------------------------------------------------------------------------
# the kernel's batched entry on the CPU: its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,M,K,N", [(5, 9, 8, 33), (1, 1, 1, 129),
                                     (3, 4, 40, 7)])
def test_gf_matmul_batched_cpu_runs_its_plain_version(B, M, K, N):
    g = torch.Generator().manual_seed(B * M + K)
    a = torch.randint(0, Q, (B, M, K), generator=g, dtype=torch.int32)
    b = torch.randint(0, Q, (B, K, N), generator=g, dtype=torch.int32)
    a[0, 0, 0] = Q - 1
    before = gf_matmul_batched.launches
    got = gf_matmul_batched(a, b)
    assert got.dtype == torch.int32 and gf_matmul_batched.launches == before
    loop = torch.stack([gf_matmul_plain(a[z], b[z]) for z in range(B)])
    assert torch.equal(got.long(), loop)
    assert torch.equal(gf_matmul_batched_plain(a, b), loop)


def test_gf_matmul_batched_rejects_bad_operands():
    a = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        gf_matmul_batched(a, torch.zeros((2, 5, 6), dtype=torch.int32))
    with pytest.raises(TypeError):
        gf_matmul_batched(a, torch.zeros((2, 4, 6), dtype=torch.int64))
