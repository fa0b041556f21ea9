"""The port's coding layer (gradient coding, Lagrange coded computing,
coded matmul) against the JAX package's, on the CPU (`device="cpu"`: the
kernels' plain versions; the simulator is host-only).

The scenarios of `tests/test_coding.py`, each also held bitwise against
`repro.coding` on the same seeded inputs: field results are exact, and
`GradientCoder.combine` sums the surviving float32 reports in worker order
and divides by n in both packages, so its result is bitwise the JAX
package's.  The straggler-tolerant train step comes with the port's
training substrate."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import coding as jcoding
from repro.core.field import FERMAT, Field
from repro_torch.api import Encoder
from repro_torch.coding import (CodedMatmul, GradientCoder, LagrangeComputer,
                                coded_gradient, default_backend)
from repro_torch.core.field import FERMAT as TFERMAT
from repro_torch.core.field import Field as TField
from repro_torch.recover import Decoder

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
CPU = "cpu"


# ---------------- group assignment / decode_weights -------------------------

@pytest.mark.parametrize("n,s", [(6, 1), (6, 2), (8, 3), (4, 0)])
def test_group_assignment_invariants(n, s):
    gc = GradientCoder(n, s)
    B = gc.encode_matrix()
    assert np.array_equal(B, jcoding.GradientCoder(n, s).encode_matrix())
    # every part covered by exactly its group's s+1 workers
    assert np.array_equal(B.sum(axis=0), np.full(n, s + 1))
    for w in range(n):
        parts = gc.parts_for_worker(w)
        assert len(parts) == s + 1
        assert all(p // (s + 1) == w // (s + 1) for p in parts)
    # any alive mask with <= s stragglers decodes: a @ B == ones
    for _ in range(10):
        dead = RNG.choice(n, size=RNG.integers(0, s + 1), replace=False)
        alive = np.array([w not in dead for w in range(n)])
        a = gc.decode_weights(alive)
        assert np.array_equal(a, jcoding.GradientCoder(n, s).decode_weights(alive))
        assert np.array_equal(a @ B, np.ones(n))
        assert np.all(a[~alive] == 0)


def test_decode_weights_group_wipeout_is_loud():
    gc = GradientCoder(6, s=1)
    alive = np.ones(6, bool)
    alive[[2, 3]] = False  # both members of group 1
    with pytest.raises(RuntimeError, match="group 1 fully straggled"):
        gc.decode_weights(alive)


def _reports(gc, rng, shapes):
    """Per-worker group sums of seeded float32 parts: numpy trees for the
    JAX package, the same values as torch trees for the port."""
    parts = [{name: rng.standard_normal(shape).astype(np.float32)
              for name, shape in shapes.items()} for _ in range(gc.n_workers)]
    reports = []
    for w in range(gc.n_workers):
        rep = {}
        for name in shapes:
            acc = parts[gc.parts_for_worker(w)[0]][name]
            for i in gc.parts_for_worker(w)[1:]:
                acc = acc + parts[i][name]
            rep[name] = acc
        reports.append(rep)
    torch_reports = [{k: torch.from_numpy(v.copy()) for k, v in r.items()}
                     for r in reports]
    return reports, torch_reports


@pytest.mark.parametrize("dead", [(), (0,), (1, 4), (5,), (0, 3, 4)])
def test_combine_bitwise_on_torch_trees(dead):
    gc = GradientCoder(6, s=1)
    jgc = jcoding.GradientCoder(6, s=1)
    reports, treports = _reports(gc, np.random.default_rng(3),
                                 {"g": (4,), "w": (3, 5)})
    alive = np.array([w not in dead for w in range(6)])
    out = gc.combine(treports, alive)
    ref = jgc.combine([{k: jnp.asarray(v) for k, v in r.items()}
                       for r in reports], alive)
    full = gc.combine(treports, np.ones(6, bool))
    for k in ("g", "w"):
        assert out[k].dtype == torch.float32
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k]))
        # bitwise, not allclose: survivors enter the sum unscaled
        assert torch.equal(out[k], full[k])


def test_combine_deprecated_shim():
    gc = GradientCoder(6, s=1)
    _, treports = _reports(gc, np.random.default_rng(4), {"g": (4,)})
    full = gc.combine(treports, np.ones(6, bool))
    with pytest.deprecated_call():
        out = coded_gradient(gc, treports, np.ones(6, bool))
    assert torch.equal(out["g"], full["g"])


def test_gradient_coder_field_encode_matches_reference():
    gc, jgc = GradientCoder(8, s=1), jcoding.GradientCoder(8, s=1)
    parts = FERMAT.rand((8, 6), np.random.default_rng(5))
    assert np.array_equal(gc.system(device=CPU).encode(parts),
                          jgc.system().encode(parts))
    assert np.array_equal(gc.system(backend="simulator").encode(parts),
                          jgc.system(backend="simulator").encode(parts))


# ---------------- unified API surface ---------------------------------------

def test_unified_signature_contract():
    # both coders: keyword-only system(*, backend=..., ...) with the
    # shared default_backend(q) resolution
    for cls, meth in [(GradientCoder, "system"), (GradientCoder, "encode_plan"),
                      (LagrangeComputer, "system"),
                      (LagrangeComputer, "encode_plan")]:
        sig = inspect.signature(getattr(cls, meth))
        for p in list(sig.parameters.values())[1:]:
            assert p.kind is inspect.Parameter.KEYWORD_ONLY, (cls, meth, p)
        assert sig.parameters["backend"].default is None, (cls, meth)
    gc = GradientCoder(4, s=1)
    with pytest.raises(TypeError):
        gc.system("local")  # positional backend is gone
    assert gc.system(device=CPU).backend == "local"  # default_backend(65537)
    assert default_backend(65537) == "local"
    assert default_backend(97) == "simulator"
    lcc = LagrangeComputer.build(TField(97), K=3, N=6)
    assert lcc.system().backend == "simulator"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CodedMatmul(4, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GradientCoder(4, s=1).system()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LagrangeComputer.build(TFERMAT, K=4, N=12).encode(np.ones((4, 2)))
    # the host-only simulator needs no device
    assert CodedMatmul(4, 2, backend="simulator").system.device is None


def test_encode_plan_session_is_cached_no_leak():
    gc = GradientCoder(8, s=1)
    before = Encoder.cache_info()
    s1 = gc.system(device=CPU)
    p1 = gc.encode_plan(device=CPU)
    for _ in range(20):
        assert gc.system(device=CPU) is s1  # one session, not one per call
        assert gc.system(device=torch.device("cpu")) is s1
        assert gc.encode_plan(device=CPU) is p1
    after = Encoder.cache_info()
    # 20 repeat calls added at most the one initial plan entry
    assert after["plans"] - before["plans"] <= 1
    assert gc.system(backend="simulator") is not s1


# ---------------- LCC decode via the shared decode-plan path ----------------

def _poly(f, deg):
    def poly(v):
        out = v
        for _ in range(deg - 1):
            out = f.mul(out, v)
        return f.add(out, 7)
    return poly


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_lcc_decode_random_subsets_and_host_parity(deg):
    lcc = LagrangeComputer.build(TFERMAT, K=4, N=12, device=CPU)
    jlcc = jcoding.LagrangeComputer.build(FERMAT, K=4, N=12)
    x = FERMAT.rand((4, 3), np.random.default_rng(deg))
    poly = _poly(FERMAT, deg)
    coded = lcc.encode(x)
    assert np.array_equal(coded, jlcc.encode(x))
    results = poly(coded)
    T = lcc.recovery_threshold(deg)
    truth = poly(x)
    rng = np.random.default_rng(10 + deg)
    for _ in range(5):
        n_live = int(rng.integers(T, lcc.N + 1))
        ids = rng.permutation(lcc.N)[:n_live]  # unsorted, random subset
        dec = lcc.decode(deg, ids, results[ids])
        assert np.array_equal(dec, truth)
        assert np.array_equal(dec, jlcc.decode(deg, ids, results[ids]))
        host = lcc._decode_host(deg, ids, results[ids])
        assert np.array_equal(host, dec)  # plan path == host fallback


def test_lcc_decode_non_fermat_host_path_matches_reference():
    lcc = LagrangeComputer.build(TField(97), K=3, N=8)
    jlcc = jcoding.LagrangeComputer.build(Field(97), K=3, N=8)
    x = Field(97).rand((3, 4), np.random.default_rng(2))
    results = lcc.encode(x)
    assert np.array_equal(results, jlcc.encode(x))
    ids = np.array([6, 1, 4, 0])
    assert np.array_equal(lcc.decode(1, ids, results[ids]),
                          jlcc.decode(1, ids, results[ids]))


def test_lcc_decode_hits_shared_plan_cache():
    lcc = LagrangeComputer.build(TFERMAT, K=4, N=12, device=CPU)
    x = FERMAT.rand((4, 2), np.random.default_rng(1))
    results = TFERMAT.mul(lcc.encode(x), 5)
    ids = np.arange(12)[2:]  # drop workers 0, 1
    lcc.decode(1, ids, results[ids])
    before = Decoder.cache_info()
    lcc.decode(1, ids, results[ids])
    after = Decoder.cache_info()
    assert after["plan_hits"] > before["plan_hits"]
    assert after["plans"] == before["plans"]


def test_lcc_decode_insufficient_workers():
    lcc = LagrangeComputer.build(TFERMAT, K=4, N=12, device=CPU)
    T = lcc.recovery_threshold(2)
    with pytest.raises(AssertionError):
        lcc.decode(2, np.arange(T - 1), np.zeros((T - 1, 2), np.int64))


# ---------------- coded inference (CodedMatmul) ------------------------------

@pytest.mark.parametrize("n_dead", [0, 1, 2])
def test_coded_matmul_every_dropout_count_bitwise(n_dead):
    K, R, b, d, out = 4, 2, 2, 8, 3
    rng = np.random.default_rng(40 + n_dead)
    X = FERMAT.rand((K * b, d), rng)
    W = FERMAT.rand((d, out), rng)
    truth = FERMAT.matmul(X, W)
    dead = rng.choice(K + R, size=n_dead, replace=False)
    jcm = jcoding.CodedMatmul(K, R)
    with CodedMatmul(K, R, device=CPU) as cm:
        shards = cm.encode(X)
        assert np.array_equal(shards, jcm.encode(X))
        got = cm(X, W, dead=dead)
        assert np.array_equal(got, truth)
        assert np.array_equal(got, jcm(X, W, dead=dead))
        with pytest.raises(ValueError, match="exceed R"):
            cm(X, W, dead=range(R + 1))
        assert not cm.system.failed  # decode heals back to healthy
    jcm.close()


def test_coded_matmul_backend_parity():
    K, R = 4, 2
    X = FERMAT.rand((K * 2, 6), RNG)
    W = FERMAT.rand((6, 4), RNG)
    with CodedMatmul(K, R, device=CPU) as loc, \
            CodedMatmul(K, R, backend="simulator") as sim:
        got_l = loc(X, W, dead=[1, 5])
        got_s = sim(X, W, dead=[1, 5])
    assert np.array_equal(got_l, got_s)
