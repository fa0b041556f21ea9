"""The port's CodedSystem quickstart against the JAX package's, bitwise, on
the CPU (`device="cpu"`: the kernels' plain versions), plus the port's
device default and its import isolation from the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import CodedSystem as JSystem
from repro.api import CodeSpec as JSpec
from repro.recover import UndecodableError as JUndecodable
from repro_torch.api import CodedSystem as TSystem
from repro_torch.api import CodeSpec as TSpec
from repro_torch.recover import Decoder, UndecodableError

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
            "repro_torch.kernels, repro_torch.launch, repro_torch.core\n"
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
            "src/repro_torch/core/schedule.py"} <= scanned
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_trace_splits_each_op_into_host_copy_and_kernel_spans():
    from repro_torch.obs.trace import Tracer

    tracer = Tracer()
    with TSystem(TSpec(kind="rs", K=16, R=4), backend="local", device="cpu",
                 trace=tracer) as t:
        x = np.random.default_rng(3).integers(0, Q, (16, W))
        cw = t.codeword(x)
        t.fail([2, 17])
        t.read(cw)
    names = [e["name"] for e in tracer.events()]
    assert names == ["host_in", "h2d", "local_encode.ntt", "d2h", "host_out",
                     "host_in", "h2d", "local_data", "d2h", "host_out"]
    assert all(e["cat"] == "kernel" for e in tracer.events())


def test_kernel_build_needs_nvcc_and_keys_on_the_source(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    paths = {build.library_path(n) for n in build.SOURCES}
    assert len(paths) == 2
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert build.library_path("ntt") == build.library_path("ntt")
