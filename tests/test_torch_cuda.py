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


@pytest.mark.cuda
@pytest.mark.parametrize("Z,C", [(1, 5), (2, 999), (64, 4099), (4096, 67)])
def test_cuda_ntt_matches_plain(cuda_device, Z, C):
    x = _cuda_rand(cuda_device, Z, C, seed=Z)
    for inverse in (False, True):
        before = ntt.launches
        got = ntt(x, inverse=inverse)
        torch.cuda.synchronize()
        assert ntt.launches == before + 1
        assert torch.equal(got.long(), ntt_plain(x, inverse=inverse))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_noncontiguous(cuda_device):
    a = _cuda_rand(cuda_device, 64, 64)
    with pytest.raises(ValueError):
        gf_matmul(a.T, a)
    with pytest.raises(ValueError):
        ntt(a.T)


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
