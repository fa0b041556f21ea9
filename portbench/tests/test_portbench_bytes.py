"""The byte counts behind every roofline, and the readers that use them on a
made-up device trace."""
import pytest

from portbench import harness, op_bytes
from portbench.devtrace import DeviceTrace

W = 1 << 19
BW = 3.35e12


def test_byte_counts():
    assert op_bytes.user_bytes(256, W) == 256 * W * 2 == 268_435_456
    assert op_bytes.encode_bytes(256, 64, W) == 320 * W * 4 == 671_088_640
    assert op_bytes.encode_bytes(6, 3, W) == 9 * W * 4 == 18_874_368
    assert op_bytes.read_bytes(256, W, 10) == 266 * W * 4
    assert op_bytes.rebuild_bytes(256, W, 64) == 320 * W * 4
    assert op_bytes.read_bytes(256, W, 0) == op_bytes.user_bytes(256, W) * 2
    # the bounds quoted in PERF.md
    assert op_bytes.encode_bytes(256, 64, W) / BW * 1e3 == pytest.approx(0.2003, abs=1e-4)
    assert op_bytes.encode_bytes(6, 3, W) / BW * 1e6 == pytest.approx(5.634, abs=1e-3)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace():
    """A 1000 us window: op 0 (0-400) with an encode range (100-300) whose
    two kernels run 150 us in all, a copy of 50 us, and op 1 (500-900)
    with one kernel of 100 us."""
    evs = [
        _x("user_annotation", "bench.window", 0, 1000),
        _x("user_annotation", "bench.codeword#0", 0, 400),
        _x("user_annotation", "local_encode.ntt", 100, 200),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 5, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", 320, 5, 3),
        _x("kernel", "ntt", 130, 100, 1),
        _x("kernel", "scale", 230, 50, 2),
        _x("gpu_memcpy", "Memcpy DtoH", 330, 50, 3),
        _x("user_annotation", "bench.codeword#1", 500, 400),
        _x("user_annotation", "local_encode.ntt", 600, 150),
        _x("cuda_runtime", "cudaLaunchKernel", 610, 5, 4),
        _x("kernel", "ntt", 620, 100, 4),
    ]
    return DeviceTrace.from_events(evs)


def record(**kw):
    rec = harness.Record("c", {}, {}, 0, 1.0, **kw)
    rec.ops = [{"op": "codeword", "i": i, "t0": 0.0, "t1": 0.5,
                "bound_bytes": op_bytes.encode_bytes(256, 64, W),
                "user_bytes": op_bytes.user_bytes(256, W)} for i in range(2)]
    return rec


def test_device_trace_busy_and_gaps():
    dt = trace()
    assert dt.window_us() == 1000
    assert dt.busy() == [(130, 280), (330, 380), (620, 720)]
    assert dt.busy_us() == 300
    gaps = dt.gaps()
    assert gaps[0] == (0, 130) and gaps[-1] == (720, 1000)
    b = dt.breakdown()
    assert b["device_ops"][0] == ["ntt", 200e-6]
    # each gap split where a host range starts or ends, named by the
    # innermost range open in each piece
    names = dict(b["idle_gaps"])
    assert names == pytest.approx({"bench.codeword": 400e-6,
                                   "local_encode.ntt": 100e-6,
                                   "no host range": 200e-6})


def test_roofline_idle_and_mfu_readers():
    rec = record(device=trace())
    bound = 2 * op_bytes.encode_bytes(256, 64, W) / BW
    pct = harness.read_metric("encode_roofline_pct.direct", rec)
    assert pct == pytest.approx(100 * bound / 250e-6)
    assert harness.read_metric("decode_roofline_pct.direct", rec) is None
    assert harness.read_metric("device_idle_pct.direct", rec) == pytest.approx(70.0)
    assert harness.read_metric("op_mfu_pct.direct", rec) == pytest.approx(
        100 * bound / 1.0)
    rec.window_start = 0.0
    assert harness.read_metric("data_gbps", rec) == pytest.approx(
        2 * op_bytes.user_bytes(256, W) / 0.5 / 1e9)


def test_readers_return_nothing_without_their_source():
    rec = record()
    for name in ("encode_roofline_pct.direct", "device_idle_pct.direct",
                 "host_ms.direct", "copy_ms.direct", "plan_decode_ms.direct"):
        assert harness.read_metric(name, rec) is None, name
