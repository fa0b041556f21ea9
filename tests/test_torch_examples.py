"""`examples_torch/`: the seven JAX examples on the port.

Each port example imports `repro_torch` and nothing of `repro` or `jax`
(an AST scan, as `test_torch_system.py` scans the package); uses every
number its JAX counterpart uses (sizes, seeds, steps, shards), read from
both sources; passes the reference's argv to the port's launchers; and,
with no `--device`, raises without a card.  The fast ones run here with
`--device cpu` (the kernels' plain versions) and print what their JAX
originals print, but for the lines that name the backend's kernels and
the timings and coalescing ratios of concurrent clients.
"""
import ast
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NAMES = ["quickstart", "coded_checkpoint_restart", "coded_system_demo",
         "coded_training_demo", "decentralized_encode_demo",
         "lagrange_coded_compute", "serve_demo"]


def _port(name: str) -> Path:
    return REPO / "examples_torch" / f"{name}.py"


def _reference(name: str) -> Path:
    return REPO / "examples" / f"{name}.py"


def _run(path: Path, *args, jax_cpu=False) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    if jax_cpu:
        env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(path), *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


def test_every_reference_example_has_a_port():
    ported = sorted(p.stem for p in (REPO / "examples_torch").glob("*.py"))
    assert ported == sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert ported == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_imports_repro_torch_and_no_jax(name):
    modules = set()
    for node in ast.walk(ast.parse(_port(name).read_text())):
        if isinstance(node, ast.Import):
            modules |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules.add(node.module.split(".")[0])
    assert "repro_torch" in modules
    assert not modules & {"repro", "jax", "jaxlib"}, modules


def _numbers(path: Path) -> Counter:
    """The numeric literals of a file's code (docstrings left out)."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return Counter(n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and id(n) not in docs
                   and type(n.value) in (int, float))


@pytest.mark.parametrize("name", NAMES)
def test_uses_every_number_of_its_reference(name):
    missing = _numbers(_reference(name)) - _numbers(_port(name))
    assert not missing, missing


def _argv(path: Path) -> list:
    """The string lists the example builds its launcher's argv from, the
    checkpoint directory's value left out."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.List) and node.elts and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                or isinstance(e, ast.Name) for e in node.elts):
            out.append([e.value if isinstance(e, ast.Constant) else "?"
                        for e in node.elts])
    for argv in out:
        if "--ckpt-dir" in argv:
            argv[argv.index("--ckpt-dir") + 1] = "?"
    return out


@pytest.mark.parametrize("name", ["quickstart", "serve_demo"])
def test_launcher_argv_is_the_reference_argv(name):
    want = _argv(_reference(name))
    got = [a for a in _argv(_port(name)) if a != ["--device", "?"]]
    assert want and got == want


@pytest.mark.parametrize("name", NAMES)
def test_raises_without_a_card(name):
    proc = _run(_port(name))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr, proc.stderr[-2000:]


def _checked(out: str) -> list:
    """The lines an example prints, but for the note naming the backend's
    kernels and what the timing of concurrent clients sets: latencies,
    coalescing ratios, batch counts."""
    lines = []
    for line in out.splitlines():
        if line.lstrip().startswith("note    :"):
            continue
        line = line.replace(" device=cpu", "")
        line = re.sub(r"p(50|99|999)=\d+us", r"p\1=?", line)
        line = re.sub(r"\d+\.\d+x", "?x", line)
        line = re.sub(r"in \d+ batches", "in ? batches", line)
        lines.append(line)
    return lines


@pytest.mark.parametrize("name", ["lagrange_coded_compute",
                                  "coded_system_demo"])
def test_prints_what_the_reference_prints(name):
    got = _run(_port(name), "--device", "cpu")
    assert got.returncode == 0, got.stderr[-3000:]
    want = _run(_reference(name), jax_cpu=True)
    assert want.returncode == 0, want.stderr[-3000:]
    assert _checked(got.stdout) == _checked(want.stdout)


def test_decentralized_encode_demo_runs_on_the_host():
    proc = _run(_port("decentralized_encode_demo"), "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "degraded read through 64 failures verified" in proc.stdout
    assert "C2 reduction from the paper's specific algorithm" in proc.stdout
