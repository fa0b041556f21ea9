"""The CUDA kernels against their plain PyTorch versions, bitwise (exact
field arithmetic: tolerance 0).  Needs an NVIDIA card: every test is marked
`cuda` and skips without one.  Imports no JAX, so it runs on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.kernels import gf_matmul, gf_matmul_plain, ntt, ntt_plain

torch.set_num_threads(1)

FERMAT_Q = 65537


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_rand(device, *shape, seed=0):
    return torch.as_tensor(_rng(seed).integers(0, FERMAT_Q, shape).astype(np.int32),
                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 300, 1003), (64, 256, 4096),
                                   (33, 4096, 129)])
def test_cuda_gf_matmul_matches_plain(cuda_device, M, K, N):
    a = _cuda_rand(cuda_device, M, K, seed=1)
    b = _cuda_rand(cuda_device, K, N, seed=2)
    before = gf_matmul.launches
    got = gf_matmul(a, b)
    torch.cuda.synchronize()
    assert gf_matmul.launches == before + 1
    assert torch.equal(got.long(), gf_matmul_plain(a, b))
    full = torch.full((M, K), FERMAT_Q - 1, dtype=torch.int32, device=cuda_device)
    fb = torch.full((K, N), FERMAT_Q - 1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(gf_matmul(full, fb).long(), gf_matmul_plain(full, fb))


def _gf_case(device, M, K, N, corner, seed):
    """Edge operands of the limb kernel: ragged M around its 32-row tiles,
    K across the 16,384 flush, N off the 128-column slab, 65536 == -1."""
    a = _rng(seed).integers(0, FERMAT_Q, (M, K))
    b = _rng(seed + 1).integers(0, FERMAT_Q, (K, N))
    if corner == "one 65536 in b":
        b[K // 2, N // 2] = FERMAT_Q - 1
    if corner == "-1 scattered over a":
        a.flat[_rng(seed).choice(a.size, max(1, a.size // 7), replace=False)] = FERMAT_Q - 1
    return (torch.as_tensor(a.astype(np.int32), device=device),
            torch.as_tensor(b.astype(np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,corner", [
    (1, 256, 300, ""), (63, 256, 1000, ""), (65, 200, 257, ""), (257, 256, 129, ""),
    (3, 16385, 131, ""), (4, 16384, 7, ""), (2, 16383, 5, ""), (1, 32769, 1, ""),
    (33, 300, 4097, "one 65536 in b"), (96, 512, 384, "-1 scattered over a"),
    (3, 0, 5, "")])
def test_cuda_gf_matmul_edge_shapes(cuda_device, M, K, N, corner):
    a, b = _gf_case(cuda_device, M, K, N, corner, seed=M + K + N)
    before = gf_matmul.launches
    got = gf_matmul(a, b)
    torch.cuda.synchronize()
    assert gf_matmul.launches == before + 1
    assert torch.equal(got.long(), gf_matmul_plain(a, b))


def _ntt_kernels(Z, inverse):
    """The kernels the wrapper launches for a Z-point transform (by Z
    alone, either direction): above 4096 the one-pass cluster kernel."""
    if Z <= 64:
        return {"registers": 1}
    if Z <= 4096:
        return {"slab": 1}
    return {"cluster": 1}


def _launched(before):
    return {k: n - before[k] for k, n in ntt.launches_by_kernel.items() if n != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("Z,C", [(1, 5), (2, 999), (64, 4099), (4096, 67),
                                 (8192, 67), (16384, 33), (65536, 5)])
def test_cuda_ntt_matches_plain(cuda_device, Z, C):
    x = _cuda_rand(cuda_device, Z, C, seed=Z)
    full = torch.full((Z, C), FERMAT_Q - 1, dtype=torch.int32, device=cuda_device)
    for inverse in (False, True):
        before = ntt.launches
        got = ntt(x, inverse=inverse)
        torch.cuda.synchronize()
        assert ntt.launches == before + sum(_ntt_kernels(Z, inverse).values())
        assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))
        assert torch.equal(ntt(full, inverse=inverse).long(),
                           ntt_plain(full, inverse=inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("Z", [1 << h for h in range(13)] + [8192, 16384, 65536])
def test_cuda_ntt_kernels_by_z(cuda_device, Z, inverse):
    """Every kernel and the boundaries between them (registers up to Z = 64,
    the two-pass slab up to 4096, the cluster kernel above), at a ragged
    width."""
    C = 1000 + 3 * Z + 1 if Z <= 4096 else 97
    x = _cuda_rand(cuda_device, Z, C, seed=Z + 7)
    before = dict(ntt.launches_by_kernel)
    got = ntt(x, inverse=inverse)
    torch.cuda.synchronize()
    assert _launched(before) == _ntt_kernels(Z, inverse)
    assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 7, 97, 4099])
@pytest.mark.parametrize("Z", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_cuda_ntt_cluster_matches_plain(cuda_device, Z, C):
    """The one-pass cluster kernel, forced, one launch a transform: ragged
    widths around its 8-column clusters and an all-65536 input, both
    directions."""
    x = _cuda_rand(cuda_device, Z, C, seed=Z + C)
    full = torch.full((Z, C), FERMAT_Q - 1, dtype=torch.int32, device=cuda_device)
    for inverse in (False, True):
        for inp in (x, full):
            before = dict(ntt.launches_by_kernel)
            got = ntt(inp, inverse=inverse, _route="cluster")
            torch.cuda.synchronize()
            assert _launched(before) == {"cluster": 1}
            assert torch.equal(got.long(), ntt_plain(inp, inverse=inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("Z", [1 << 13, 1 << 14, 1 << 15, 1 << 16])
def test_cuda_ntt_two_pass_route_matches_plain(cuda_device, Z):
    """The forced two-pass route (leading stages, then the slab on each
    4096-row block; the other way round for the inverse) still holds."""
    x = _cuda_rand(cuda_device, Z, 99, seed=Z + 1)
    for inverse in (False, True):
        before = dict(ntt.launches_by_kernel)
        got = ntt(x, inverse=inverse, _route="two-pass")
        torch.cuda.synchronize()
        assert _launched(before) == {"outer": 1, "slab": 1}
        assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))


@pytest.mark.cuda
def test_cuda_ntt_refused_cluster_launch_raises(cuda_device, monkeypatch):
    """A cluster launch the card refuses raises, counts no launch and is not
    replaced by another kernel or the plain version."""
    import importlib

    from repro_torch.kernels import build

    mod = importlib.import_module("repro_torch.kernels.ntt")
    x = _cuda_rand(cuda_device, 8192, 33, seed=5)
    root, scale = mod.roots(8192, False)
    tw, otwist, stwist = mod._device_twist("cluster", 8192, root, scale, x.device)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    # no cluster kernel for these log2 Z: refused, nothing runs
    for H in (12, 17, 0, -1):
        err = mod._cluster_launcher()(x.data_ptr(), out.data_ptr(), otwist.data_ptr(),
                                      stwist.data_ptr(), tw.ctypes.data, H, 33, 0,
                                      stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(err, "ntt (cluster)")

    def refused(*args):
        return 9  # cudaErrorInvalidConfiguration

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mod, "_cluster_launcher", lambda: refused)
    monkeypatch.setattr(mod, "ntt_plain", no_plain)
    before, n = dict(ntt.launches_by_kernel), ntt.launches
    for inverse in (False, True):
        with pytest.raises(RuntimeError, match="cluster"):
            ntt(x, inverse=inverse, _route="cluster")
        with pytest.raises(RuntimeError, match="cluster"):
            ntt(x, inverse=inverse)
    torch.cuda.synchronize()
    assert ntt.launches == n and ntt.launches_by_kernel == before


@pytest.mark.cuda
def test_cuda_wrappers_refuse_noncontiguous(cuda_device):
    a = _cuda_rand(cuda_device, 64, 64)
    with pytest.raises(ValueError):
        gf_matmul(a.T, a)
    with pytest.raises(ValueError):
        ntt(a.T)
    with pytest.raises(ValueError):  # 2^17 does not divide q - 1
        ntt(torch.zeros((1 << 17, 1), dtype=torch.int32, device=cuda_device))


@pytest.mark.cuda
def test_cuda_encode_blocks_launches_below_old_threshold(cuda_device):
    """Every CUDA call launches the kernel: no small-shape plain path."""
    from repro_torch.kernels import ops

    x = _cuda_rand(cuda_device, 4, 200, seed=3)
    coeffs = _cuda_rand(cuda_device, 4, 3, seed=4)
    before = gf_matmul.launches
    got = ops.encode_blocks(x, coeffs)
    assert gf_matmul.launches == before + 1
    assert torch.equal(got.long(), gf_matmul_plain(coeffs.T, x))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,R", [("rs", 16, 4), ("rs", 24, 6),
                                      ("lagrange", 4, 8), ("dft", 16, 16)])
def test_cuda_quickstart_matches_cpu(cuda_device, kind, K, R):
    from repro_torch.api import CodedSystem, CodeSpec

    spec = CodeSpec(kind=kind, K=K, R=R)
    gpu = CodedSystem(spec, backend="local")
    cpu = CodedSystem(spec, backend="local", device="cpu")
    assert gpu.device.type == "cuda"
    x = _rng(K + R).integers(0, FERMAT_Q, (K, 300))
    cw = gpu.codeword(x)
    assert np.array_equal(cw, cpu.codeword(x))
    dead = sorted({1, K + R - 1})
    for s in (gpu, cpu):
        s.fail(dead)
    lost = cw.copy()
    lost[dead] = 0
    assert np.array_equal(gpu.read(lost), x)
    assert np.array_equal(gpu.rebuild(lost), cw)
    assert gpu.failed == ()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["codeword", "encode", "read", "rebuild",
                                "decode"])
def test_cuda_device_residues_match_cpu(cuda_device, op):
    """The caller's rows as they are (negatives, values >= q, int64's
    extremes, int32, strided) at 2^12 and 2^16 columns in turn, so the
    pinned buffers are reused across sizes: bitwise the CPU session's
    answers, each a fresh int64 array."""
    from repro_torch.api import CodedSystem, CodeSpec
    from torch_payloads import KINDS, payload

    spec = CodeSpec(kind="rs", K=16, R=4)
    gpu = CodedSystem(spec, backend="local")
    cpu = CodedSystem(spec, backend="local", device="cpu")
    dead = [1, 7, 19]
    last = None
    for i, kind in enumerate(KINDS):
        for w in (1 << 12, 1 << 16):
            x, v = payload(kind, 16, w, seed=i), payload(kind, 20, w, seed=w)
            got = []
            for s in (gpu, cpu):
                if op in ("codeword", "encode"):
                    got.append(getattr(s, op)(x))
                else:
                    s.fail(dead)
                    got.append(getattr(s, op)(v))
            assert got[0].dtype == np.int64 and got[0].flags.c_contiguous
            assert np.array_equal(got[0], got[1]), (kind, w)
            assert last is None or not np.shares_memory(got[0], last)
            last = got[0]
    assert gpu.failed == cpu.failed


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["codeword", "read", "rebuild"])
def test_cuda_dropped_answer_is_reused(cuda_device, op):
    """On the card, an answer the caller let go between calls is handed
    out again (`host_out`'s `reused`) and is bitwise the CPU session's."""
    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.obs import trace
    from torch_payloads import payload

    spec = CodeSpec(kind="rs", K=16, R=4)
    gpu = CodedSystem(spec, backend="local")
    cpu = CodedSystem(spec, backend="local", device="cpu")
    dead, w = [1, 7, 19], 1 << 16

    def run(s, seed):
        if op == "codeword":
            return s.codeword(payload("negatives", 16, w, seed=seed))
        s.fail(dead)
        return getattr(s, op)(payload("int32", 20, w, seed=seed))

    a = run(gpu, 1)
    ptr = a.ctypes.data
    del a
    with trace.installed() as tracer:
        b = run(gpu, 2)
    assert b.ctypes.data == ptr
    assert [e["args"]["reused"] for e in tracer.events()
            if e["name"] == "host_out"] == [True]
    assert np.array_equal(b, run(cpu, 2))


# ---------------- the stream pipeline, the queue --------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,R", [("rs", 16, 4), ("universal", 16, 4)])
@pytest.mark.parametrize("chunk_w", [1, 7, 128, 1000])
def test_cuda_stream_pipeline_matches_cpu(cuda_device, kind, K, R, chunk_w):
    """The pipelined encode_stream/decode_stream (copy stream, pinned
    buffers, events) equals the CPU's, ragged last chunk included."""
    from repro_torch.api import CodedSystem, CodeSpec

    spec = CodeSpec(kind=kind, K=K, R=R, seed=0 if kind == "universal" else None)
    gpu = CodedSystem(spec, backend="local", chunk_w=chunk_w)
    cpu = CodedSystem(spec, backend="local", device="cpu")
    W = 300 if chunk_w > 1 else 40
    x = _rng(K + chunk_w).integers(0, FERMAT_Q, (K, W))
    cw = cpu.codeword(x)
    blocks = list(gpu.encode_stream(x))
    assert len(blocks) == -(-W // chunk_w)
    assert np.array_equal(np.concatenate(blocks, axis=1), cw[K:])
    dead = [1, K + R - 1]
    for s in (gpu, cpu):
        s.fail(dead)
    lost = cw.copy()
    lost[dead] = 0
    got = np.concatenate(list(gpu.decode_stream(lost)), axis=1)
    assert np.array_equal(got, cpu.decode(lost))
    healed = np.concatenate(list(gpu.rebuild_stream(lost)), axis=1)
    assert np.array_equal(healed, cw) and gpu.failed == ()


@pytest.mark.cuda
def test_cuda_queue_worker_matches_direct_calls(cuda_device):
    from repro_torch.api import CodedSystem, CodeSpec

    system = CodedSystem(CodeSpec(kind="rs", K=16, R=4), backend="local")
    assert system._ensure_queue().device.type == "cuda"
    xs = [_rng(i).integers(0, FERMAT_Q, (16, 50 + 31 * i)) for i in range(6)]
    futs = [system.submit("encode", x) for x in xs]
    for f, x in zip(futs, xs):
        assert np.array_equal(f.result(timeout=120), system.encode(x))
    cw = system.codeword(xs[0])
    system.fail([3, 18])
    assert np.array_equal(system.submit("decode", cw).result(timeout=120),
                          system.decode(cw))
    assert np.array_equal(system.submit("rebuild", cw).result(timeout=120), cw)
    system.close()


@pytest.mark.cuda
def test_cuda_stream_raises_when_the_kernel_library_cannot_load(cuda_device,
                                                               monkeypatch):
    """A CUDA plan's stream never falls back to the CPU loop."""
    import importlib

    from repro_torch.api import CodeSpec, Encoder

    # the module (the package exports the wrapper function under its name)
    gf_mod = importlib.import_module("repro_torch.kernels.gf_matmul")

    def unloadable():
        raise OSError("libgf_matmul.so: cannot open shared object file")

    plan = Encoder.plan(CodeSpec(kind="universal", K=16, R=4, seed=0),
                        backend="local")
    assert plan.local_impl == "dense"
    monkeypatch.setattr(gf_mod, "_launcher", unloadable)
    x = _rng(5).integers(0, FERMAT_Q, (16, 64))
    with pytest.raises(OSError, match="cannot open"):
        list(plan.run_stream(x, chunk_w=16))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 16, 256])
def test_cuda_gf_solve_matches_cpu(cuda_device, n):
    from repro_torch.kernels import gf_gauss_inverse, gf_matmul, gf_solve

    a = _rng(n).integers(0, FERMAT_Q, (n, n))
    b = _rng(n + 1).integers(0, FERMAT_Q, (n, 1000))
    inv = gf_gauss_inverse(a, device=cuda_device)
    assert inv.device.type == "cuda"
    assert torch.equal(inv.cpu(), gf_gauss_inverse(a, device="cpu"))
    # the host waits on the device once, for the singular check at the end
    a_dev = torch.as_tensor(a, device=cuda_device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inv_dev = gf_gauss_inverse(a_dev, device=cuda_device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    assert len(waits) == 1, [str(w.message) for w in waits]
    assert torch.equal(inv_dev, inv)
    before = gf_matmul.launches
    x = gf_solve(a, b, device=cuda_device)
    assert gf_matmul.launches == before + 1
    assert torch.equal(x.cpu(), gf_solve(a, b, device="cpu"))
    with pytest.raises(ValueError, match="singular"):
        gf_gauss_inverse(np.zeros((4, 4), np.int64), device=cuda_device)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_cpu_byte_for_byte(cuda_device, tmp_path):
    from collections import OrderedDict

    from repro_torch.ckpt import CodedCheckpointer
    from repro_torch.kernels import gf_matmul, ntt

    g = torch.Generator().manual_seed(0)
    state = OrderedDict([
        ("w", torch.randn(300, 257, generator=g).to(torch.bfloat16).to(cuda_device)),
        ("b", torch.randn(1001, generator=g).to(cuda_device)),
        ("step", torch.tensor(12))])
    card = CodedCheckpointer(str(tmp_path / "card"), 16, 4)
    assert card._system.device.type == "cuda"
    n0 = ntt.launches
    card.save(1, state, background=True)
    card.wait()
    assert ntt.launches > n0
    host = CodedCheckpointer(str(tmp_path / "host"), 16, 4, device="cpu")
    host.save(1, state)
    for p in sorted((tmp_path / "card" / "step_000001").glob("*.npy")):
        assert p.read_bytes() == (tmp_path / "host" / "step_000001" / p.name).read_bytes()
    example = OrderedDict((k, v.cpu()) for k, v in state.items())
    m0 = gf_matmul.launches
    got = card.restore(1, example, failed_shards={2, 5, 11, 14})
    assert gf_matmul.launches > m0
    cpu_got = CodedCheckpointer(str(tmp_path / "card"), 16, 4,
                                device="cpu").restore(1, example,
                                                      failed_shards={0, 1})
    for k, v in example.items():
        for t in (got[k], cpu_got[k]):
            assert t.dtype == v.dtype and t.device.type == "cpu"
            assert torch.equal(t.view(torch.int16) if v.dtype == torch.bfloat16
                               else t, v.view(torch.int16)
                               if v.dtype == torch.bfloat16 else v), k


@pytest.mark.cuda
def test_cuda_service_runs_its_queue_on_the_card(cuda_device):
    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.launch import CodedService

    spec = CodeSpec(kind="rs", K=16, R=4)
    ref = CodedSystem(spec, backend="local", device="cpu")
    xs = [_rng(20 + i).integers(0, FERMAT_Q, (16, 64)) for i in range(8)]
    with CodedService() as svc:  # device=None: the card
        sess = svc.session("t0", spec)
        assert svc.device.type == "cuda"
        assert sess.device == svc.device == svc._queue.device
        futs = [svc.submit(f"t{i % 2}", spec, "encode", x)
                for i, x in enumerate(xs)]
        for f, x in zip(futs, xs):
            assert np.array_equal(f.result(timeout=120), ref.encode(x))
        cw = ref.codeword(xs[0])
        sess.fail([1, 17])
        assert np.array_equal(svc.submit("t0", spec, "decode", cw)
                              .result(timeout=120), cw[[1, 17]])
        st = svc.stats()["service"]
        assert st["requests"] == 9 and st["inflight_ops"] == 0


# ---------------------------------------------------------------------------
# gf_matmul's batched entry and the mesh backend on the card
# ---------------------------------------------------------------------------

def _batched_case(device, B, M, K, N, seed):
    a = _rng(seed).integers(0, FERMAT_Q, (B, M, K))
    b = _rng(seed + 1).integers(0, FERMAT_Q, (B, K, N))
    if K:
        a[0, 0, 0] = FERMAT_Q - 1  # 65536 == -1 in one batch's a only
        b[B - 1, K - 1, N // 2] = FERMAT_Q - 1
    return (torch.as_tensor(a.astype(np.int32), device=device),
            torch.as_tensor(b.astype(np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,K,N", [
    (256, 9, 8, 1 << 18),            # the mesh combine at rs K=256 R=64
    (1, 1, 1, 129), (3, 33, 300, 1000), (5, 9, 8, 7), (2, 64, 256, 4096)])
def test_cuda_gf_matmul_batched_matches_plain(cuda_device, B, M, K, N):
    from repro_torch.kernels import gf_matmul_batched, gf_matmul_batched_plain

    a, b = _batched_case(cuda_device, B, M, K, N, seed=B + M + K)
    before = gf_matmul_batched.launches
    got = gf_matmul_batched(a, b)
    torch.cuda.synchronize()
    assert gf_matmul_batched.launches == before + 1
    assert torch.equal(got.long(), gf_matmul_batched_plain(a, b))
    if B * N <= 4096:
        for z in range(B):
            assert torch.equal(got[z].long(), gf_matmul_plain(a[z], b[z]))


# (B, M, K, N): the mesh's combines (rs 16/4, 64/16, 128/64 and 256/64 at
# a narrower W), N % 4 in {1, 2, 3} with a ragged last tile, M = K = 1,
# K = 0, the small design's largest a, and the sweep's deeper shapes
_BATCHED_DESIGN_CASES = [
    (16, 3, 2, 4096), (64, 5, 4, 4096), (128, 9, 8, 4096), (256, 9, 8, 1 << 14),
    (7, 9, 8, 4097), (7, 9, 8, 4098), (7, 9, 8, 4099), (3, 1, 1, 5000),
    (2, 4, 0, 100), (2, 64, 32, 1000), (64, 17, 16, 2048), (32, 33, 32, 1027)]


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["small", "imma"])
@pytest.mark.parametrize("B,M,K,N", _BATCHED_DESIGN_CASES)
def test_cuda_gf_matmul_batched_designs_match_plain(cuda_device, design, B, M,
                                                    K, N):
    from repro_torch.kernels import gf_matmul_batched, gf_matmul_batched_plain

    a, b = _batched_case(cuda_device, B, M, K, N, seed=3 * B + M + K)
    before = dict(gf_matmul_batched.launches_by_design)
    total = gf_matmul_batched.launches
    got = gf_matmul_batched(a, b, _design=design)
    torch.cuda.synchronize()
    assert gf_matmul_batched.launches == total + 1
    assert gf_matmul_batched.launches_by_design == dict(
        before, **{design: before[design] + 1})
    assert torch.equal(got.long(), gf_matmul_batched_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["small", "imma"])
@pytest.mark.parametrize("B,M,K,N,offset", [(3, 9, 8, 4096, 1), (2, 9, 8, 1001, 3),
                                            (4, 33, 32, 1000, 0)])
def test_cuda_gf_matmul_batched_designs_all_65536_and_unaligned(
        cuda_device, design, B, M, K, N, offset):
    """All-65536 operands (the largest sums), and a base of b off 16 bytes
    (the small design's scalar path)."""
    from repro_torch.kernels import gf_matmul_batched, gf_matmul_batched_plain

    a = torch.full((B, M, K), FERMAT_Q - 1, dtype=torch.int32, device=cuda_device)
    flat = torch.full((B * K * N + offset,), FERMAT_Q - 1, dtype=torch.int32,
                      device=cuda_device)
    b = flat[offset:].view(B, K, N)
    got = gf_matmul_batched(a, b, _design=design)
    assert torch.equal(got.long(), gf_matmul_batched_plain(a, b))
    a2, b2 = _batched_case(cuda_device, B, M, K, N, seed=N)
    flat[offset:] = b2.reshape(-1)
    assert torch.equal(gf_matmul_batched(a2, b, _design=design).long(),
                       gf_matmul_batched_plain(a2, b))


@pytest.mark.cuda
def test_cuda_mesh_combine_shape_takes_the_small_design(cuda_device):
    from repro_torch.kernels import gf_matmul_batched, gf_matmul_batched_plain

    a, b = _batched_case(cuda_device, 256, 9, 8, 4096, seed=5)
    before = dict(gf_matmul_batched.launches_by_design)
    got = gf_matmul_batched(a, b)
    torch.cuda.synchronize()
    assert gf_matmul_batched.launches_by_design == dict(
        before, small=before["small"] + 1)
    assert torch.equal(got.long(), gf_matmul_batched_plain(a, b))


@pytest.mark.cuda
def test_cuda_gf_matmul_batched_small_refuses_deep_k(cuda_device):
    from repro_torch.kernels import gf_matmul_batched

    a, b = _batched_case(cuda_device, 2, 9, 33, 64, seed=6)
    with pytest.raises(ValueError, match="small design"):
        gf_matmul_batched(a, b, _design="small")


@pytest.mark.cuda
def test_cuda_gf_matmul_batched_rejects_too_many_batches(cuda_device):
    from repro_torch.kernels import gf_matmul_batched

    a = torch.zeros((65536, 1, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="65535"):
        gf_matmul_batched(a, a)


@pytest.mark.cuda
def test_cuda_gf_matmul_still_launches_once_per_call(cuda_device):
    from repro_torch.kernels import gf_matmul_batched

    a = _cuda_rand(cuda_device, 256, 256, seed=3)
    b = _cuda_rand(cuda_device, 256, 4096, seed=4)
    before, batched = gf_matmul.launches, gf_matmul_batched.launches
    got = gf_matmul(a, b)
    torch.cuda.synchronize()
    assert gf_matmul.launches == before + 1
    assert gf_matmul_batched.launches == batched
    assert torch.equal(got.long(), gf_matmul_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["universal", "rs"])
def test_cuda_mesh_codeword_matches_local(cuda_device, method):
    from repro_torch.api import CodedSystem, CodeSpec
    from repro_torch.kernels import gf_matmul_batched

    spec = CodeSpec(kind="rs", K=256, R=64)
    x = _rng(11).integers(0, FERMAT_Q, (256, 4096))
    local = CodedSystem(spec, backend="local")
    mesh = CodedSystem(spec, backend="mesh", method=method)
    assert mesh.encode_plan.method == method
    before = gf_matmul_batched.launches
    cw = mesh.codeword(x)
    stages = (1 if method == "universal"
              else 2 * (mesh.encode_plan.tables.mesh_tables("rs").dl_inv_univ
                        is not None))
    assert gf_matmul_batched.launches == before + stages
    assert np.array_equal(cw, local.codeword(x))
    mesh.fail(list(range(0, 320, 5)))
    assert np.array_equal(mesh.rebuild(cw), cw)
    mesh.close()
    local.close()


# ---------------------------------------------------------------------------
# the model substrate and the model server on the card
# ---------------------------------------------------------------------------

def _model_archs():
    from repro_torch.configs import ARCH_IDS

    return [a for a in ARCH_IDS if a != "paper_rs"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", _model_archs())
def test_cuda_smoke_decode_matches_forward(cuda_device, arch):
    """Stepwise decode == one full forward at smoke width on the card, in
    bf16, at the JAX package's tolerance (atol 0.15, rtol 0.05)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch).smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = M.init_params(cfg, gen, cuda_device)
    B, S = 2, 8
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=cuda_device)
    fwd, enc = {"tokens": toks}, None
    if cfg.family == "encdec":
        fwd["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model), generator=gen,
                                    device=cuda_device)
        enc = M.encode_frames(cfg, model, fwd["frames"].to(torch.bfloat16))
    cache = M.init_cache(cfg, B, 64, enc)
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(cfg, model, toks[:, t], t, cache, enc)
        outs.append(lg)
    step = torch.stack(outs, 1).float()
    full = M.forward(cfg, model, fwd).float()
    assert step.device.type == full.device.type == "cuda"
    assert torch.isfinite(full).all()
    torch.testing.assert_close(step, full, atol=0.15, rtol=0.05)


@pytest.mark.cuda
def test_cuda_init_params_default_device(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("qwen3_1_7b").smoke()
    model = M.init_params(cfg)
    assert all(p.device.type == "cuda" for p in model.parameters())
    assert M.init_cache(cfg, 1, 4)["k"].device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("degraded", [False, True])
def test_cuda_selfcheck_launches_ntt_and_gf_matmul(cuda_device, degraded, capsys):
    """The coded self-check of a smoke tree on the card: the NTT encodes
    (rs 8/2: the register kernel), `gf_matmul` recovers (the DecodePlan, or
    `gf_solve`'s apply), and the codeword equals the CPU's bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference

    cfg = get_config("qwen3_1_7b").smoke()
    tree = to_reference(M.init_params(cfg, None, cuda_device))
    gm, nt = gf_matmul.launches, ntt.launches_by_kernel["registers"]
    full = LS._coded_selfcheck(tree, 8, 2, degraded=degraded)
    torch.cuda.synchronize()
    assert ntt.launches_by_kernel["registers"] > nt
    assert gf_matmul.launches > gm
    assert np.array_equal(full, LS._coded_selfcheck(tree, 8, 2, degraded=degraded,
                                                    device="cpu"))
    assert capsys.readouterr().out.count("coded self-check OK") == 2


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", _model_archs())
def test_cuda_smoke_train_step(cuda_device, arch):
    """One `value_and_grad` at smoke width on the card (bf16): every leaf's
    gradient on the card and finite; after one SGD update the loss is
    still finite (`tests/test_archs.py::test_smoke_train_step`)."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_map
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference

    cfg = get_config(arch).smoke()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = to_reference(M.init_params(cfg, gen, cuda_device))
    B, S = 2, 32
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=cuda_device),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=cuda_device)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen, device=cuda_device)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.n_frames, cfg.d_model),
                                      generator=gen, device=cuda_device)
    loss, grads = M.value_and_grad(cfg, params, batch)
    assert torch.isfinite(loss)
    for g, p in zip(tree_flatten(grads)[0], tree_flatten(params)[0]):
        assert g.device.type == "cuda" and g.dtype == p.dtype
        assert torch.isfinite(g.float()).all()
    new = tree_map(lambda p, g: p - 0.5 * g.to(p.dtype), params, grads)
    assert torch.isfinite(M.loss_fn(cfg, new, batch))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3_1_7b", "phi3_5_moe_42b_a6_6b",
                                  "mamba2_780m", "hymba_1_5b"])
def test_cuda_coded_step_is_deterministic_and_bitwise(cuda_device, arch):
    """The all-alive coded step twice from one state gives the same bits,
    and every pattern of at most s stragglers gives the all-alive params
    (remat on: the full configs' setting)."""
    import dataclasses

    from repro_torch.coding import GradientCoder
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.data import SyntheticLM
    from repro_torch.train import (init_state, make_straggler_train_step,
                                   make_train_setup)

    cfg = dataclasses.replace(get_config(arch).smoke(), remat=True)
    opt, _ = make_train_setup(cfg, total_steps=20, peak_lr=5e-3)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = init_state(cfg, gen, opt, cuda_device)
    batch = SyntheticLM(cfg.vocab, 16, 8).device_batch(0, cuda_device)
    step = make_straggler_train_step(cfg, opt, GradientCoder(4, s=1))
    was = torch.are_deterministic_algorithms_enabled()
    ref, _ = step(state, batch)
    assert torch.are_deterministic_algorithms_enabled() == was
    leaves = tree_flatten(ref)[0]
    assert all(t.device.type == "cuda" for t in leaves)
    for dead in (None, [0], [1], [3], [0, 2]):
        alive = None if dead is None else np.isin(np.arange(4), dead, invert=True)
        got, _ = step(state, batch, alive)
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(got)[0], leaves))
    with pytest.raises(RuntimeError, match="fully straggled"):
        step(state, batch, np.array([False, False, True, True]))


@pytest.mark.cuda
def test_cuda_train_launcher_failure_injection(cuda_device, tmp_path, capsys):
    """The JAX launcher's failure-injection scenario on the card: the
    parity encode launches the NTT kernel, the degraded restore
    `gf_matmul`, and the restored state is back on the card."""
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.launch import train as LT

    gm, nt = gf_matmul.launches, ntt.launches_by_kernel["registers"]
    res = LT.main(["--steps", "14", "--ckpt-dir", str(tmp_path / "ck"),
                   "--ckpt-every", "10", "--fail-at", "12,1,3",
                   "--seq-len", "32", "--batch", "4", "--stragglers", "1",
                   "--coded-workers", "4", "--straggler-selfcheck"])
    out = capsys.readouterr().out
    assert "reconstructed from parity" in out and "selfcheck OK" in out
    assert "done: final loss" in out
    assert ntt.launches_by_kernel["registers"] > nt
    assert gf_matmul.launches > gm
    assert all(t.device.type == "cuda" for t in tree_flatten(res.state)[0])
