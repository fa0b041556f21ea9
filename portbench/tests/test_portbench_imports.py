"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, since `repro_torch` begins with `repro`), and a reference
that imports nothing of the program."""
import ast
import os
import subprocess
import sys

from portbench import harness

BENCH = harness.BENCH
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH)
                 for f in fs if f.endswith(".py") and "tests" not in d)


def imported(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_the_jax_package_or_its_benchmarks():
    for path in SOURCES:
        bad = imported(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "op_bytes.py", "peaks.py"):
        assert imported(os.path.join(BENCH, name)) <= {"__future__", "numpy",
                                                       "torch", "dataclasses",
                                                       "math"}, name
    code = ("import sys; sys.path[0:0] = [%r]; import portbench.reference as r; "
            "r.encode(r.np.ones((6, 4), r.np.int64), r.rs_generator(6, 3)); "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'repro_torch'))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_whole_run_loads_no_jax():
    """Every module under portbench imported, a small run of each kind made,
    then sys.modules read as the command reads it."""
    code = f"""
import importlib, os, sys
sys.path[0:0] = [{str(harness.ROOT)!r}, {os.path.join(str(harness.ROOT), 'src')!r}]
from portbench import harness
for d, _, fs in os.walk(harness.BENCH):
    for f in fs:
        if f.endswith('.py') and 'tests' not in d and 'metrics' not in d:
            mod = os.path.relpath(os.path.join(d, f[:-3]), harness.ROOT)
            importlib.import_module(mod.replace(os.sep, '.').removesuffix('.__init__'))
from portbench.tests import small
for cell in ('hdfs-rs-6-3.encode', 'paper-rs-256-64.repair'):
    small.run(cell, seconds=0.2, trace=True)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert "repro_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert "repro.fake" in harness.forbidden_modules()
