"""The CUDA kernels against their plain PyTorch versions, bitwise (exact
field arithmetic: tolerance 0).  Needs an NVIDIA card: every test is marked
`cuda` and skips without one.  Imports no JAX, so it runs on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
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


def _ntt_kernels(Z):
    """The kernels the wrapper launches for a Z-point transform."""
    if Z <= 64:
        return {"registers": 1}
    if Z <= 4096:
        return {"slab": 1}
    return {"outer": 1, "slab": 1}


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
        assert ntt.launches == before + sum(_ntt_kernels(Z).values())
        assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))
        assert torch.equal(ntt(full, inverse=inverse).long(),
                           ntt_plain(full, inverse=inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("Z", [1 << h for h in range(13)] + [8192, 16384, 65536])
def test_cuda_ntt_kernels_by_z(cuda_device, Z, inverse):
    """Every kernel and the boundaries between them (registers up to Z = 64,
    the two-pass slab up to 4096, the leading stages and the slab above), at
    a ragged width."""
    C = 1000 + 3 * Z + 1 if Z <= 4096 else 97
    x = _cuda_rand(cuda_device, Z, C, seed=Z + 7)
    before = dict(ntt.launches_by_kernel)
    got = ntt(x, inverse=inverse)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in ntt.launches_by_kernel.items() if n != before[k]}
    assert launched == _ntt_kernels(Z)
    assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))


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
