"""The port's multi-tenant serving layer against the JAX package's, on
the CPU (`device="cpu"`: the kernels' plain versions).

The scenarios of `tests/test_service.py` — session pooling, admission
control (quotas, backpressure, weighted-fair waiter grants), cross-session
coalescing with its isolation guarantee (two tenants with different
generator matrices never share a batch), per-tenant/per-tag stats, the
`CodingQueue` submit/close race — with each future held bitwise against
the JAX package's direct call on the same inputs, plus chaos under
service load (random `fail`s racing queued submissions) with zero silent
drops.

The blocking-backend fixture (`_GatedBackend`, registered in the port's
backend registry) holds the queue worker inside `encode` until the test
releases it, so tests can pile requests into the queue deterministically
and assert exactly how they coalesce.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.core.field import FERMAT
from repro_torch.api import (
    Backend,
    CodeSpec,
    register_backend,
    unregister_backend,
)
from repro_torch.launch import CodedService, CodingQueue, QueueFullError, TenantQuota
from repro_torch.launch.tenancy import AdmissionController, percentile

torch.set_num_threads(1)

RNG = np.random.default_rng(41)
CPU = "cpu"


def _wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# end-to-end round trips through the service
# ---------------------------------------------------------------------------

def test_service_round_trip_encode_decode_rebuild():
    spec = CodeSpec(kind="rs", K=8, R=4, W=6)
    x = FERMAT.rand((8, 6), RNG)
    ref = JSystem(JSpec(kind="rs", K=8, R=4, W=6), backend="local")
    cw = ref.codeword(x)
    with CodedService(backend="local", device=CPU) as svc:
        parity = svc.submit("t0", spec, "encode", x).result(timeout=60)
        assert np.array_equal(parity, cw[8:])

        sess = svc.session("t0", spec)
        sess.fail((2, 9))
        lost = svc.submit("t0", spec, "decode", cw).result(timeout=60)
        assert np.array_equal(lost, cw[[2, 9]])
        healed = svc.submit("t0", spec, "rebuild", cw).result(timeout=60)
        assert np.array_equal(healed, cw)

        st = svc.stats()
        t = st["tenants"]["t0"]
        assert t["submitted"] == 3 and t["completed"] == 3
        assert t["failed"] == 0 and t["inflight_ops"] == 0
        assert st["service"]["requests"] == 3
    with pytest.raises(RuntimeError):
        svc.submit("t0", spec, "encode", x)
    with pytest.raises(RuntimeError):
        svc.session("t0", spec)


def test_session_pool_identity_and_lru_eviction():
    spec = CodeSpec(kind="rs", K=8, R=4)
    svc = CodedService(backend="local", device=CPU, max_sessions=2)
    try:
        s0 = svc.session("a", spec)
        assert svc.session("a", spec) is s0          # pooled, not rebuilt
        assert svc.session("b", spec) is not s0      # per-tenant sessions
        # a session with live erasure state must survive eviction: its
        # failure pattern is system truth, not a cache entry
        s0.fail(1)
        svc.session("c", spec)
        assert svc.sessions == 2                     # b evicted, a kept
        assert svc.session("a", spec) is s0
        assert svc.session("a", spec).failed == (1,)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# a backend whose encode blocks until released — deterministic queue piling
# ---------------------------------------------------------------------------

class _GatedBackend(Backend):
    """Host matmul that holds the queue worker until `gate` is set;
    `entered` proves the worker is INSIDE an execution (its batch is
    sealed), so later submissions deterministically pile into the NEXT
    drain rather than racing into the current one."""

    gate = threading.Event()
    entered = threading.Event()

    def encode(self, plan, x):
        type(self).entered.set()
        type(self).gate.wait(timeout=60)
        return plan.field.matmul(plan.A.T, x)

    def decode(self, plan, v):
        type(self).entered.set()
        type(self).gate.wait(timeout=60)
        return plan.field.matmul(plan.tables.D.T, v)


@pytest.fixture()
def gated_backend():
    _GatedBackend.gate = threading.Event()
    _GatedBackend.entered = threading.Event()
    register_backend("gated-host", _GatedBackend)
    try:
        yield "gated-host"
    finally:
        _GatedBackend.gate.set()
        unregister_backend("gated-host")


def test_cross_session_coalescing_shares_one_batch(gated_backend):
    """Same (spec, backend, A-digest) from DIFFERENT tenants coalesces
    into one batch; every future still gets its own rows."""
    spec = CodeSpec(kind="rs", K=8, R=4, W=4)
    xs = [FERMAT.rand((8, 4), RNG) for _ in range(4)]
    plan_ref = JSystem(JSpec(kind="rs", K=8, R=4, W=4), backend="local")
    with CodedService(backend=gated_backend, device=CPU) as svc:
        # occupy the worker so the next submissions pile up and coalesce
        warm = svc.submit("t0", spec, "encode", xs[0])
        assert _GatedBackend.entered.wait(timeout=60)
        futs = [svc.submit(f"t{i % 2}", spec, "encode", x, tag="shared")
                for i, x in enumerate(xs)]
        _wait_until(lambda: svc.queue_depth == 5, what="5 queued ops")
        _GatedBackend.gate.set()
        for x, fut in zip(xs, futs):
            assert np.array_equal(fut.result(timeout=60),
                                  plan_ref.codeword(x)[8:])
        warm.result(timeout=60)
        st = svc.stats()
        # 1 warmup batch + 1 coalesced batch of 4 (cross-tenant)
        assert st["service"]["requests"] == 5
        assert st["service"]["batches"] == 2
        assert st["tags"]["shared"]["coalescing_ratio"] == pytest.approx(4.0)


def test_tenant_matrices_never_share_a_batch(gated_backend):
    """Two tenants, same spec, DIFFERENT explicit A matrices: their
    requests must never coalesce into one execution — each future is
    bitwise its own matrix's parity and each group holds one tenant."""
    K, R, W = 8, 4, 4
    spec = CodeSpec(kind="universal", K=K, R=R, W=W)
    rng = np.random.default_rng(97)
    A1, A2 = FERMAT.rand((K, R), rng), FERMAT.rand((K, R), rng)
    assert not np.array_equal(A1, A2)
    x = FERMAT.rand((K, W), rng)
    with CodedService(backend=gated_backend, device=CPU) as svc:
        warm = svc.submit("ta", spec, "encode", x, A=A1)
        assert _GatedBackend.entered.wait(timeout=60)
        futs_a = [svc.submit("ta", spec, "encode", x, A=A1, tag="volA")
                  for _ in range(2)]
        futs_b = [svc.submit("tb", spec, "encode", x, A=A2, tag="volB")
                  for _ in range(2)]
        _wait_until(lambda: svc.queue_depth == 5, what="5 queued ops")
        _GatedBackend.gate.set()
        exp_a = FERMAT.matmul(A1.T, x)
        exp_b = FERMAT.matmul(A2.T, x)
        assert not np.array_equal(exp_a, exp_b)
        for fut in futs_a:
            assert np.array_equal(fut.result(timeout=60), exp_a)
        for fut in futs_b:
            assert np.array_equal(fut.result(timeout=60), exp_b)
        warm.result(timeout=60)
        st = svc.stats()
        # the 4 piled ops split into TWO digest-keyed batches, never one
        assert st["service"]["batches"] == 3  # warmup + volA + volB
        assert st["tags"]["volA"]["coalescing_ratio"] == pytest.approx(2.0)
        assert st["tags"]["volB"]["coalescing_ratio"] == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# admission control through the service
# ---------------------------------------------------------------------------

def test_admission_quota_rejects_loudly_and_recovers(gated_backend):
    spec = CodeSpec(kind="rs", K=8, R=4, W=4)
    x = FERMAT.rand((8, 4), RNG)
    with CodedService(backend=gated_backend, device=CPU,
                      default_quota=TenantQuota(max_inflight_ops=2)) as svc:
        f1 = svc.submit("t0", spec, "encode", x)
        f2 = svc.submit("t0", spec, "encode", x)
        with pytest.raises(QueueFullError):
            svc.submit("t0", spec, "encode", x, block=False)
        with pytest.raises(QueueFullError):
            svc.submit("t0", spec, "encode", x, timeout=0.05)
        # another tenant is NOT throttled by t0's quota
        f3 = svc.submit("t1", spec, "encode", x, block=False)
        _GatedBackend.gate.set()
        for f in (f1, f2, f3):
            f.result(timeout=60)
        # slots released on completion: t0 admits again
        _wait_until(lambda: svc.stats()["service"]["inflight_ops"] == 0,
                    what="slots released")
        svc.submit("t0", spec, "encode", x, block=False).result(timeout=60)
        assert svc.stats()["tenants"]["t0"]["rejected"] == 2


def test_admission_backpressure_blocks_then_admits(gated_backend):
    spec = CodeSpec(kind="rs", K=8, R=4, W=4)
    x = FERMAT.rand((8, 4), RNG)
    with CodedService(backend=gated_backend, device=CPU,
                      default_quota=TenantQuota(max_inflight_ops=1)) as svc:
        first = svc.submit("t0", spec, "encode", x)
        got = {}

        def blocked_submit():
            got["fut"] = svc.submit("t0", spec, "encode", x)  # blocks

        th = threading.Thread(target=blocked_submit)
        th.start()
        _wait_until(lambda: svc.stats()["service"]["waiting"] == 1,
                    what="submission waiting on admission")
        assert "fut" not in got
        _GatedBackend.gate.set()      # first op completes -> slot frees
        th.join(timeout=60)
        assert not th.is_alive()
        assert np.array_equal(got["fut"].result(timeout=60),
                              first.result(timeout=60))


# ---------------------------------------------------------------------------
# AdmissionController unit behavior (fairness, FIFO, bookkeeping)
# ---------------------------------------------------------------------------

def test_admission_weighted_fair_grant_order():
    """When slots free, the grant goes to the tenant with the smallest
    weight-normalized in-flight load — not to the earliest waiter."""
    ac = AdmissionController(max_ops=2)
    ac.acquire("hog")
    ac.acquire("hog")            # hog holds the whole service
    order = []
    cv = threading.Condition()

    def waiter(tenant):
        ac.acquire(tenant)
        with cv:
            order.append(tenant)
            cv.notify_all()

    t_hog = threading.Thread(target=waiter, args=("hog",))
    t_hog.start()                # hog queues FIRST (earlier seq)
    _wait_until(lambda: ac.waiting == 1, what="hog waiter queued")
    t_light = threading.Thread(target=waiter, args=("light",))
    t_light.start()
    _wait_until(lambda: ac.waiting == 2, what="both waiters queued")

    ac.release("hog")            # one slot frees: light must win it
    with cv:
        assert cv.wait_for(lambda: len(order) == 1, timeout=10)
        assert order == ["light"]
    ac.release("hog")            # now hog's waiter gets the next slot
    with cv:
        assert cv.wait_for(lambda: len(order) == 2, timeout=10)
        assert order == ["light", "hog"]
    t_hog.join(timeout=10)
    t_light.join(timeout=10)
    ops, _ = ac.inflight()
    assert ops == 2


def test_admission_weight_biases_grants():
    """A weight-2 tenant is allowed twice the in-flight load before its
    waiter loses priority: with 2 ops in flight each, heavy (2/2=1) beats
    light (2/1=2) for the freed slot — despite light queueing FIRST."""
    ac = AdmissionController(max_ops=5)
    ac.set_quota("heavy", TenantQuota(weight=2.0))
    for t in ("heavy", "light"):
        ac.acquire(t)
        ac.acquire(t)
    ac.acquire("z")              # fills the 5th slot; freed below
    order = []
    cv = threading.Condition()

    def waiter(tenant):
        ac.acquire(tenant)
        with cv:
            order.append(tenant)
            cv.notify_all()

    t_light = threading.Thread(target=waiter, args=("light",))
    t_light.start()              # light queues first
    _wait_until(lambda: ac.waiting == 1, what="light waiter queued")
    t_heavy = threading.Thread(target=waiter, args=("heavy",))
    t_heavy.start()
    _wait_until(lambda: ac.waiting == 2, what="both waiters queued")
    ac.release("z")              # heavy 2/2=1.0 beats light 2/1=2.0
    with cv:
        assert cv.wait_for(lambda: len(order) == 1, timeout=10)
        assert order == ["heavy"]
    ac.release("light")          # light's own slot frees its waiter
    t_light.join(timeout=10)
    t_heavy.join(timeout=10)


def test_admission_tenant_fifo_no_bypass():
    """An op never jumps ahead of its own tenant's queued waiters, even
    when a slot is technically free at submit time."""
    ac = AdmissionController(max_ops=1)
    ac.acquire("t")

    def waiter():
        ac.acquire("t")

    th = threading.Thread(target=waiter)
    th.start()
    _wait_until(lambda: ac.waiting == 1, what="waiter queued")
    with pytest.raises(QueueFullError):
        ac.acquire("t", block=False)
    ac.release("t")              # waiter takes the slot, not the bypasser
    th.join(timeout=10)
    assert ac.inflight("t") == (1, 0)
    ac.release("t")
    ac.acquire("t", block=False)  # no waiters left: fast path admits


def test_admission_oversized_payload_runs_alone():
    ac = AdmissionController(max_bytes=100)
    ac.acquire("t", nbytes=1000)          # empty ledger: admitted alone
    with pytest.raises(QueueFullError):
        ac.acquire("t", nbytes=1, block=False)
    ac.release("t", nbytes=1000)
    ac.acquire("t", nbytes=1, block=False)


# ---------------------------------------------------------------------------
# CodingQueue submit/close race (regression)
# ---------------------------------------------------------------------------

def test_queue_submit_after_close_raises():
    spec = CodeSpec(kind="rs", K=8, R=4, W=4)
    q = CodingQueue(backend="local", device=CPU)
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.submit_encode(spec, FERMAT.rand((8, 4), RNG))


def test_queue_submit_close_race_never_hangs():
    """Hammer the submit/close boundary: every submit either returns a
    future that RESOLVES or raises RuntimeError immediately — a submission
    accepted during close must not strand its future."""
    spec = CodeSpec(kind="rs", K=8, R=4, W=2)
    x = FERMAT.rand((8, 2), RNG)
    for _ in range(5):
        q = CodingQueue(backend="local", device=CPU)
        futs, raised = [], []
        start = threading.Barrier(4)

        def submitter():
            start.wait(timeout=10)
            for _ in range(20):
                try:
                    futs.append(q.submit_encode(spec, x))
                except RuntimeError:
                    raised.append(1)
                    return

        threads = [threading.Thread(target=submitter) for _ in range(3)]
        for t in threads:
            t.start()
        start.wait(timeout=10)
        q.close(timeout=60)
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for fut in futs:          # accepted => resolved, never stranded
            assert np.asarray(fut.result(timeout=60)).shape == (4, 2)


# ---------------------------------------------------------------------------
# stats plumbing
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert percentile(xs, 0.50) == 50
    assert percentile(xs, 0.99) == 99
    assert percentile(xs, 0.999) == 100
    assert percentile([7], 0.999) == 7
    assert np.isnan(percentile([], 0.5))


def test_describe_and_latency_reservoir():
    spec = CodeSpec(kind="rs", K=8, R=4, W=4)
    x = FERMAT.rand((8, 4), RNG)
    with CodedService(backend="local", device=CPU) as svc:
        for _ in range(3):
            svc.submit("acme", spec, "encode", x, tag="v0").result(timeout=60)
        text = svc.describe()
        assert "acme" in text and "v0" in text and "coalesce=" in text
        lats = svc.latencies_us("acme")
        assert len(lats) == 3 and all(v > 0 for v in lats)
        assert len(svc.latencies_us()) == 3
        snap = svc.stats()["tenants"]["acme"]
        assert snap["p50_us"] <= snap["p99_us"] <= snap["p999_us"]


# ---------------------------------------------------------------------------
# the port's device contract
# ---------------------------------------------------------------------------

def test_service_queue_and_sessions_share_the_device():
    spec = CodeSpec(kind="rs", K=8, R=4)
    with CodedService(backend="local", device=CPU) as svc:
        sess = svc.session("t0", spec)
        assert svc.device == torch.device("cpu")
        assert sess.device == svc.device == svc._queue.device
        assert "device=cpu" in svc.describe()
        assert svc.stats()["service"]["device"] == "cpu"
    with CodedService(backend="simulator") as sim:
        assert sim.device is None
        assert sim.session("t0", spec).device is None


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CodedService()


# ---------------------------------------------------------------------------
# the serving demos' scenarios (the JAX package's launch/serve.py)
# ---------------------------------------------------------------------------

def test_two_tenant_service_load_and_degraded_read():
    """Two tenants' client threads drive one service (same spec, so their
    encodes coalesce across sessions), then one tenant degrades; every
    future equals the JAX package's direct call."""
    spec = CodeSpec(kind="rs", K=8, R=4)
    ref = JSystem(JSpec(kind="rs", K=8, R=4), backend="local")
    with CodedService(backend="local", device=CPU) as svc:
        svc.set_quota("acme", TenantQuota(max_inflight_ops=4, weight=2.0))
        futs, lock = [], threading.Lock()

        def client(tenant, seed):
            r = np.random.default_rng(seed)
            for _ in range(12):
                x = FERMAT.rand((8, 16), r)
                f = svc.submit(tenant, spec, "encode", x, tag=f"{tenant}/v0")
                with lock:
                    futs.append((ref.codeword(x)[8:], f))

        threads = [threading.Thread(target=client, args=(t, 50 + i))
                   for i, t in enumerate(["acme", "zeta"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for want, fut in futs:
            assert np.array_equal(fut.result(timeout=60), want)
        x = FERMAT.rand((8, 16), np.random.default_rng(99))
        cw = ref.codeword(x)
        svc.session("zeta", spec).fail(range(4))
        got = svc.submit("zeta", spec, "decode", cw).result(timeout=60)
        assert np.array_equal(got, cw[:4])
        st = svc.stats()
        assert st["service"]["requests"] == 25
        for t in ("acme", "zeta"):
            assert st["tenants"][t]["failed"] == 0
            assert st["tenants"][t]["inflight_ops"] == 0


def test_chaos_under_service_load_drops_nothing():
    """Random `fail`s racing queued encode/decode/rebuild submissions of two
    tenants (rs 8/2): every future resolves bitwise — to the rows of the
    pattern it was pinned to — and every admitted op is accounted for."""
    spec = CodeSpec(kind="rs", K=8, R=2)
    rng = np.random.default_rng(7)
    with CodedService(backend="local", device=CPU) as svc:
        tens = []
        for t in range(2):
            name = f"tenant{t}"
            xt = FERMAT.rand((8, 64), rng)
            sess = svc.session(name, spec)
            tens.append((name, sess, xt, sess.codeword(xt)))
        sfuts = []
        for _ in range(36):
            name, sess, xt, cwt = tens[int(rng.integers(2))]
            roll = rng.random()
            if roll < 0.3 and len(sess.failed) < spec.R:
                alive = [i for i in range(spec.N) if i not in sess.failed]
                sess.fail(int(rng.choice(alive)))
            elif roll < 0.6:
                sfuts.append(("encode", None, cwt,
                              svc.submit(name, spec, "encode", xt)))
            elif roll < 0.85:
                sfuts.append(("decode", sess.failed, cwt,
                              svc.submit(name, spec, "decode", cwt)))
            else:
                sfuts.append(("rebuild", None, cwt,
                              svc.submit(name, spec, "rebuild", cwt)))
        assert sfuts
        for op, pinned, cwt, fut in sfuts:
            got = fut.result(timeout=120)
            ref = (cwt[8:] if op == "encode"
                   else cwt[list(pinned)] if op == "decode" else cwt)
            assert np.array_equal(got, ref), op
        st = svc.stats()
        done = sum(t["completed"] for t in st["tenants"].values())
        assert done == len(sfuts) == st["service"]["requests"]
        assert sum(t["failed"] for t in st["tenants"].values()) == 0
        assert st["service"]["inflight_ops"] == 0
