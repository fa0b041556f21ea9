"""The port's streaming engine, coding queue and streamed session ops against
the JAX package's, bitwise, on the CPU (`device="cpu"`: the kernels' plain
versions; the simulator is host-only either way).

Same seeded numpy inputs through `repro` and `repro_torch`; every output
must be equal, with no tolerance."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.api import Encoder as JEncoder
from repro.api.stream import default_chunk_w as j_default_chunk_w
from repro.api.stream import iter_chunks as j_iter_chunks
from repro.api.stream import split_chunks as j_split_chunks
from repro.launch.coding_queue import CodingQueue as JQueue
from repro.recover import Decoder as JDecoder
from repro_torch.api import CodedSystem as TSystem
from repro_torch.api import CodeSpec as TSpec
from repro_torch.api import Encoder as TEncoder
from repro_torch.api import StreamStats, default_chunk_w
from repro_torch.api import stream as tstream
from repro_torch.launch import CodingQueue as TQueue
from repro_torch.launch import QueueStats
from repro_torch.recover import Decoder as TDecoder

torch.set_num_threads(1)

Q = 65537
BACKENDS = ("simulator", "local")
# (kind, K, R, seed)
KINDS = [("rs", 16, 4, None), ("rs", 8, 8, None), ("lagrange", 8, 4, None),
         ("dft", 8, 8, None), ("universal", 8, 4, 3)]


def _specs(kind, K, R, seed=None):
    return (JSpec(kind=kind, K=K, R=R, seed=seed),
            TSpec(kind=kind, K=K, R=R, seed=seed))


def _enc_pair(kind, K, R, seed, backend):
    js, ts = _specs(kind, K, R, seed)
    return (JEncoder.plan(js, backend=backend),
            TEncoder.plan(ts, backend=backend, device="cpu"))


def _cat(blocks):
    return np.concatenate(list(blocks), axis=1)


def _ragged_bounds(W, seed):
    """Seeded ragged split of [0, W) into 1-5 pieces."""
    rng = np.random.default_rng(seed)
    cuts = rng.choice(np.arange(1, W), size=int(rng.integers(0, 5)),
                      replace=False)
    return sorted({0, W, *cuts.tolist()})


# ---------------- plans: run_stream / run_batched ---------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,K,R,seed", KINDS)
def test_encode_stream_matches_reference(kind, K, R, seed, backend):
    jp, tp = _enc_pair(kind, K, R, seed, backend)
    x = np.random.default_rng(K + R).integers(0, Q, (K, 69))
    ref = jp.run(x)
    assert np.array_equal(tp.run(x), ref)
    got = _cat(tp.run_stream(x, chunk_w=16))
    assert np.array_equal(got, _cat(jp.run_stream(x, chunk_w=16)))
    assert np.array_equal(got, ref)
    chunks = [x[:, :5], x[:, 5:38], x[:, 38:]]
    assert np.array_equal(_cat(tp.run_stream(chunks)),
                          _cat(jp.run_stream(chunks)))
    if backend == "simulator":
        js, ts = jp.stream_stats, tp.stream_stats
        assert (ts.widths, ts.C1, ts.C2) == (js.widths, js.C1, js.C2)


@pytest.mark.parametrize("seed", range(6))
def test_ragged_chunk_lists_match_reference(seed):
    """Seeded ragged chunkings of rs 8/4 (encode and a decode of a seeded
    pattern) stream bitwise like the JAX package's whole-W run."""
    rng = np.random.default_rng(100 + seed)
    W = int(rng.integers(1, 41))
    bounds = _ragged_bounds(W, seed)
    js, ts = _specs("rs", 8, 4)
    x = rng.integers(0, Q, (8, W))
    jenc = JEncoder.plan(js, backend="local")
    tenc = TEncoder.plan(ts, backend="local", device="cpu")
    ref = jenc.run(x)
    pieces = [x[:, a:b] for a, b in zip(bounds, bounds[1:])]
    assert np.array_equal(_cat(tenc.run_stream(pieces, chunk_w=7)), ref)
    erased = tuple(sorted(rng.permutation(12)[: int(rng.integers(0, 5))]))
    jdec = JDecoder.plan(js, erased=erased, backend="local")
    tdec = TDecoder.plan(ts, erased=erased, backend="local", device="cpu")
    v = np.concatenate([x % Q, ref])[list(tdec.kept)]
    got = _cat(tdec.run_stream([v[:, a:b] for a, b in zip(bounds, bounds[1:])]))
    assert np.array_equal(got, jdec.run(v))


@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_batched_mixed_widths_match_reference(backend):
    jp, tp = _enc_pair("rs", 8, 4, None, backend)
    x = np.random.default_rng(2).integers(0, Q, (8, 50))
    payloads = [x[:, :7], x[:, 7], x[:, 8:50]]
    got = tp.run_batched(payloads, chunk_w=16)
    want = jp.run_batched(payloads, chunk_w=16)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[1].shape == (4,)  # 1-D request, 1-D reply
    assert tp.run_batched([]) == []


def test_zero_width_batches_match_reference():
    js, ts = _specs("rs", 8, 4)
    empty = np.zeros((8, 0), np.int64)
    tenc = TEncoder.plan(ts, backend="local", device="cpu")
    jenc = JEncoder.plan(js, backend="local")
    assert tenc.run_batched([empty])[0].shape == \
        jenc.run_batched([empty])[0].shape == (4, 0)
    tdec = TDecoder.plan(ts, erased=(0, 9), backend="local", device="cpu")
    assert tdec.run_batched([empty])[0].shape == (2, 0)
    assert list(tenc.run_stream(empty)) == []
    # the round network refuses a zero-width run in both packages alike
    tsim = TEncoder.plan(ts, backend="simulator")
    jsim = JEncoder.plan(js, backend="simulator")
    with pytest.raises(ValueError) as terr:
        tsim.run_batched([empty])
    with pytest.raises(ValueError) as jerr:
        jsim.run_batched([empty])
    assert str(terr.value) == str(jerr.value)
    assert list(tsim.run_stream(empty)) == []


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("erased", [(0, 5, 9), (2,), (8, 9, 10, 11), ()],
                         ids=["mixed", "one", "all_parity", "none"])
def test_decode_stream_matches_reference(erased, backend):
    js, ts = _specs("rs", 8, 4)
    x = np.random.default_rng(6).integers(0, Q, (8, 45))
    cw = np.concatenate([x % Q, JEncoder.plan(js, backend="local").run(x)])
    jp = JDecoder.plan(js, erased=erased, backend=backend)
    tp = TDecoder.plan(ts, erased=erased, backend=backend, device="cpu")
    v = cw[list(tp.kept)]
    ref = jp.run(v)
    got = tp.run_stream(v, chunk_w=16)
    blocks = list(got)
    assert all(b.shape[0] == len(erased) for b in blocks)
    assert np.array_equal(_cat(blocks), ref)
    outs = tp.run_batched([v[:, :10], v[:, 10:]], chunk_w=16)
    assert np.array_equal(np.concatenate(outs, axis=1), ref)
    if backend == "simulator" and erased:
        list(jp.run_stream(v, chunk_w=16))
        list(tp.run_stream(v, chunk_w=16))
        j_, t_ = jp.stream_stats, tp.stream_stats
        assert (t_.widths, t_.C1, t_.C2) == (j_.widths, j_.C1, j_.C2)


@pytest.mark.parametrize("kind,K,R,seed", KINDS)
def test_simulator_stream_stats_per_chunk_match_reference(kind, K, R, seed):
    """Per-chunk C1/C2 of a simulator stream at the JAX package's default
    chunk width, and each chunk equal to a standalone run of that chunk."""
    jp, tp = _enc_pair(kind, K, R, seed, "simulator")
    assert tstream.plan_chunk_w(tp) == j_default_chunk_w(K)
    x = np.random.default_rng(3).integers(0, Q, (K, 40))
    assert np.array_equal(_cat(tp.run_stream(x, chunk_w=16)),
                          _cat(jp.run_stream(x, chunk_w=16)))
    t, j = tp.stream_stats, jp.stream_stats
    assert t.widths == j.widths == [16, 16, 8]
    assert (t.C1, t.C2) == (j.C1, j.C2)
    for (w0, w1), c1, c2 in zip([(0, 16), (16, 32), (32, 40)], t.C1, t.C2):
        tp.run(x[:, w0:w1])
        assert (tp.last_stats.C1, tp.last_stats.C2) == (c1, c2)
    assert t.chunks == 3 and t.W == 40 and t.totals() == j.totals()
    list(tp.run_stream(x))          # default chunk width: one chunk
    assert tp.stream_stats.widths == [40]


def test_chunk_validation_and_widths_match_reference():
    for fn in (lambda: list(tstream.iter_chunks(np.zeros((4, 8)), 8, 16)),
               lambda: list(tstream.split_chunks(np.zeros(8), 4))):
        with pytest.raises(ValueError, match="stream chunks must be"):
            fn()
    with pytest.raises(ValueError) as terr:
        list(tstream.iter_chunks([np.zeros((8, 3)), np.zeros((7, 3))], 8, 2))
    with pytest.raises(ValueError) as jerr:
        list(j_iter_chunks([np.zeros((8, 3)), np.zeros((7, 3))], 8, 2))
    assert str(terr.value) == str(jerr.value)
    x = np.arange(8 * 10).reshape(8, 10)
    for cw in (1, 3, 10, 11):
        got = [c.tolist() for c in tstream.split_chunks([x, x[:, :4]], cw)]
        assert got == [c.tolist() for c in j_split_chunks([x, x[:, :4]], cw)]
    for K in (1, 8, 16, 256, 4096, 1 << 16):
        assert default_chunk_w(K) == j_default_chunk_w(K)
        assert default_chunk_w(K) % 128 == 0
    st_ = StreamStats()
    assert st_.chunks == 0 and st_.totals() == (0, 0)
    tp = TEncoder.plan(TSpec(kind="rs", K=16, R=4), backend="local",
                       device="cpu")
    assert tstream.plan_chunk_w(tp) == default_chunk_w(
        16, budget_bytes=tstream.DEVICE_BUDGET_BYTES)


def test_pipeline_holds_at_most_two_chunks():
    """The pipeline reads one chunk ahead: when chunk k's output is
    yielded, chunks k and k+1 have been drawn, never k+2."""
    tp = TEncoder.plan(TSpec(kind="rs", K=8, R=4), backend="local",
                       device="cpu")
    x = np.random.default_rng(4).integers(0, Q, (8, 30))
    drawn = []

    def feed():
        for i in range(0, 30, 5):
            drawn.append(i // 5)
            yield x[:, i:i + 5]

    for k, y in enumerate(tp.run_stream(feed(), chunk_w=5)):
        assert max(drawn) <= k + 1
        assert np.array_equal(y, tp.run(x[:, 5 * k:5 * k + 5]))
    paired = list(tstream.run_paired_stream(
        tp, tstream.split_chunks(x, 7), lambda c: c, chunk_w=7))
    assert [c.shape[1] for c, _ in paired] == [7, 7, 7, 7, 2]
    assert np.array_equal(np.concatenate([y for _, y in paired], 1), tp.run(x))


def test_pipeline_spans_are_on_the_stream_track():
    from repro_torch.obs.trace import Tracer, installed

    tp = TEncoder.plan(TSpec(kind="rs", K=8, R=4), backend="local",
                       device="cpu")
    x = np.random.default_rng(5).integers(0, Q, (8, 12))
    with installed(Tracer()) as tracer:
        list(tp.run_stream(x, chunk_w=5))
    evs = tracer.events()
    names = [e["name"] for e in evs]
    # h2d of chunk k+1 is enqueued before chunk k is dispatched
    assert names == ["h2d", "h2d", "dispatch", "materialize", "h2d",
                     "dispatch", "materialize", "dispatch", "materialize"]
    assert [e["args"]["chunk"] for e in evs] == [0, 1, 0, 0, 2, 1, 1, 2, 2]
    assert all(e["cat"] == "stream" for e in evs)


# ---------------- session streams -------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,K,R,seed,erased", [
    ("rs", 8, 4, None, (2, 4, 11)), ("universal", 8, 4, 5, (0, 9)),
    ("lagrange", 8, 4, None, (1, 10)), ("dft", 8, 8, None, (5, 9, 13))])
def test_session_streams_match_reference(kind, K, R, seed, erased, backend):
    js, ts = _specs(kind, K, R, seed)
    j = JSystem(js, backend=backend, chunk_w=8)
    t = TSystem(ts, backend=backend, chunk_w=8, device="cpu")
    x = np.random.default_rng(K * R).integers(0, Q, (K, 37))
    cw = t.codeword(x)
    assert np.array_equal(cw, j.codeword(x))
    assert np.array_equal(_cat(t.encode_stream(x)), _cat(j.encode_stream(x)))
    widths = [1, 12, 0, 24]
    xs = [x[:, :1], x[:, 1:13], x[:, 13:13], x[:, 13:]]
    got = t.encode_batched(xs)
    assert [g.shape[1] for g in got] == widths
    assert all(np.array_equal(g, w) for g, w in zip(got, j.encode_batched(xs)))
    for s in (j, t):
        s.fail(erased)
    lost = cw.copy()
    lost[list(erased)] = 0
    assert np.array_equal(_cat(t.decode_stream(lost)), _cat(j.decode_stream(lost)))
    pieces = [lost[:, :20], lost[:, 20:]]
    healed = _cat(t.rebuild_stream(pieces))
    assert np.array_equal(healed, cw)
    assert t.failed == ()
    j.rebuild(lost)
    for s in (j, t):   # survivors-only rebuild: the complement plan
        s.fail(erased)
    surv = cw[list(t.kept)]
    assert np.array_equal(_cat(t.rebuild_stream(surv, chunk_w=5)),
                          _cat(j.rebuild_stream(surv, chunk_w=5)))
    assert t.failed == j.failed == ()


def test_rebuild_stream_pins_its_pattern_and_heals_on_exhaustion():
    js, ts = _specs("rs", 8, 4)
    j = JSystem(js, backend="local")
    t = TSystem(ts, backend="local", device="cpu")
    x = np.random.default_rng(7).integers(0, Q, (8, 30))
    cw = t.codeword(x)
    for s in (j, t):
        s.fail([1, 9])
    lost = cw.copy()
    lost[[1, 9]] = 0
    tgen, jgen = t.rebuild_stream(lost, chunk_w=8), j.rebuild_stream(lost, chunk_w=8)
    first_t, first_j = next(tgen), next(jgen)
    for s in (j, t):
        s.fail([3])          # lands mid-stream: not part of the pinned pattern
    rest_t, rest_j = list(tgen), list(jgen)
    assert np.array_equal(np.concatenate([first_t] + rest_t, 1), cw)
    assert np.array_equal(np.concatenate([first_t] + rest_t, 1),
                          np.concatenate([first_j] + rest_j, 1))
    assert t.failed == j.failed == (3,)   # only the pinned pattern healed
    # an empty stream heals too
    assert list(t.rebuild_stream([])) == []
    assert t.failed == ()


def test_decode_stream_under_churn_matches_reference():
    """A decode stream keeps the pattern it was created with while the
    session's failure set changes under it."""
    js, ts = _specs("rs", 16, 4)
    j = JSystem(js, backend="local", chunk_w=4)
    t = TSystem(ts, backend="local", chunk_w=4, device="cpu")
    x = np.random.default_rng(8).integers(0, Q, (16, 21))
    cw = t.codeword(x)
    for s in (j, t):
        s.fail([0, 17])
    tgen, jgen = t.decode_stream(cw), j.decode_stream(cw)
    got = [next(tgen)]
    want = [next(jgen)]
    for s in (j, t):
        s.fail([5]).heal([0])
    got += list(tgen)
    want += list(jgen)
    assert np.array_equal(_cat(got), _cat(want))
    assert np.array_equal(_cat(got), cw[[0, 17]])
    assert t.failed == j.failed == (5, 17)
    assert np.array_equal(_cat(t.decode_stream(cw)), cw[[5, 17]])


# ---------------- the coding queue ------------------------------------------

def test_queue_coalesces_bitwise_like_reference():
    js, ts = _specs("rs", 8, 4)
    rng = np.random.default_rng(8)
    jq = JQueue(backend="local", chunk_w=128)
    tq = TQueue(backend="local", chunk_w=128, device="cpu")
    assert tq.device == torch.device("cpu")
    erased = (0, 3)
    enc = TEncoder.plan(ts, backend="local", device="cpu")
    dec = TDecoder.plan(ts, erased=erased, backend="local", device="cpu")
    payloads = [rng.integers(0, Q, (8, int(w))) for w in rng.integers(3, 40, 12)]
    futs = []
    lock = threading.Lock()

    def client(x):
        v = np.concatenate([x % Q, enc.run(x)])[list(dec.kept)]
        with lock:
            futs.append((tq.submit_encode(ts, x), jq.submit_encode(js, x),
                         enc.run(x)))
            futs.append((tq.submit_decode(ts, erased, v),
                         jq.submit_decode(js, erased, v), dec.run(v)))

    threads = [threading.Thread(target=client, args=(x,)) for x in payloads]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)   # many thread switches inside submit
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(futs) == 24
    for tf, jf, direct in futs:
        got = tf.result(timeout=60)
        assert np.array_equal(got, jf.result(timeout=60))
        assert np.array_equal(got, direct)
    tq.close()
    jq.close()
    assert tq.stats.requests == 24
    assert tq.stats.batches <= tq.stats.requests
    assert isinstance(tq.stats, QueueStats)
    with pytest.raises(RuntimeError, match="closed"):
        tq.submit_encode(ts, payloads[0])


def test_queue_coalesces_a_burst_into_one_group():
    ts = TSpec(kind="rs", K=8, R=4)
    tq = TQueue(backend="local", device="cpu")
    xs = [np.random.default_rng(i).integers(0, Q, (8, 5 + i)) for i in range(8)]
    gate = _park_worker(tq)          # hold the worker while the burst lands
    futs = [tq.submit_encode(ts, x) for x in xs]
    gate.set()
    enc = TEncoder.plan(ts, backend="local", device="cpu")
    for f, x in zip(futs, xs):
        assert np.array_equal(f.result(timeout=60), enc.run(x))
    tq.close()
    assert tq.stats.max_coalesced == 8


def _park_worker(q):
    """Make q's worker wait on a gate before draining (test hook)."""
    gate = threading.Event()
    orig = q._drain

    def drain(first):
        gate.wait(30)
        return orig(first)
    q._drain = drain
    return gate


@pytest.mark.parametrize("op", ["decode", "rebuild"])
def test_queue_failover_onto_superset_matches_reference(op):
    js, ts = _specs("rs", 8, 4)
    x = np.random.default_rng(9).integers(0, Q, (8, 11))
    out = {}
    for name, Sys, kw in (("j", JSystem, {}), ("t", TSystem, {"device": "cpu"})):
        s = Sys(js if name == "j" else ts, backend="local", **kw)
        cw = s.codeword(x)
        s.fail([2])
        q = s._ensure_queue()
        gate = _park_worker(q)
        fut = s.submit(op, cw)
        time.sleep(0.05)
        s.fail([5])                       # the pinned (2,) grows to (2, 5)
        gate.set()
        out[name] = (fut.result(timeout=60), q.stats.failovers, cw)
        s.close()
    (tres, tfo, cw), (jres, jfo, _) = out["t"], out["j"]
    assert np.array_equal(tres, jres)
    assert tfo == jfo == 1
    assert np.array_equal(tres, cw[[2]] if op == "decode" else cw)


def test_queue_k_row_payload_fails_its_future_on_failover():
    ts = TSpec(kind="rs", K=8, R=4)
    s = TSystem(ts, backend="local", device="cpu")
    x = np.random.default_rng(10).integers(0, Q, (8, 6))
    cw = s.codeword(x)
    s.fail([2])
    survivors = cw[list(s.kept)]
    q = s._ensure_queue()
    gate = _park_worker(q)
    bad = s.submit("decode", survivors)     # (K, W): cannot be re-sliced
    good = s.submit("decode", cw)
    time.sleep(0.05)
    s.fail([5])
    gate.set()
    with pytest.raises(RuntimeError, match="pattern invalidated mid-flight"):
        bad.result(timeout=60)
    assert np.array_equal(good.result(timeout=60), cw[[2]])
    s.close()


def test_queue_close_timeout_fails_pending_futures():
    ts = TSpec(kind="rs", K=8, R=4)
    q = TQueue(backend="local", device="cpu")
    gate = _park_worker(q)
    fut = q.submit_encode(ts, np.ones((8, 3), np.int64))
    with pytest.raises(RuntimeError, match="did not drain"):
        q.close(timeout=0.1)
    with pytest.raises(RuntimeError, match="did not drain"):
        fut.result(timeout=1)
    gate.set()


def test_session_queue_must_match_backend_and_device():
    ts = TSpec(kind="rs", K=8, R=4)
    q = TQueue(backend="local", device="cpu")
    try:
        with pytest.raises(ValueError, match="shared queue"):
            TSystem(ts, backend="simulator", queue=q)
        s = TSystem(ts, backend="local", device="cpu", queue=q)
        x = np.random.default_rng(11).integers(0, Q, (8, 4))
        assert np.array_equal(s.submit_encode(x).result(timeout=60),
                              s.encode(x))
        s.close()                       # a shared queue stays open
        assert np.array_equal(q.submit_encode(ts, x).result(timeout=60),
                              s.encode(x))
    finally:
        q.close()
    sim = TQueue(backend="simulator", device="cpu")
    assert sim.device is None           # host-only: no device
    sim.close()


def test_timeline_overlap_and_busy_arithmetic():
    """The overlap and busy sums of `PipelineTimeline` over given spans
    (the CUDA events themselves are read only on the card)."""
    tl = tstream.PipelineTimeline()
    spans = [[{"h2d": (0.0, 2.0), "kernels": (2.5, 4.0), "d2h": (4.0, 4.5)},
              {"h2d": (3.0, 5.0), "kernels": (5.0, 6.0), "d2h": (6.0, 6.5)},
              {"h2d": (7.0, 8.0), "kernels": (8.0, 9.0), "d2h": (9.0, 9.2)}],
             [{"h2d": (0.0, 1.0), "kernels": (1.0, 2.0), "d2h": (2.0, 3.0)}]]
    tl.chunk_spans_ms = lambda: spans
    # chunk 1's copy ran during [3, 4] of chunk 0's kernels; chunk 2's
    # copy began after chunk 1's kernels ended
    assert tl.overlap_ms() == pytest.approx(1.0)
    # run 0: [0, 2] + [2.5, 6.5] + [7, 9.2]; run 1: [0, 3]
    assert tl.busy_ms() == pytest.approx(2.0 + 4.0 + 2.2 + 3.0)
    with tstream.record_timeline() as rec:
        list(TEncoder.plan(TSpec(kind="rs", K=8, R=4), backend="local",
                           device="cpu").run_stream(np.ones((8, 9)), chunk_w=4))
    assert rec.runs == []        # the CPU loop records no device events
