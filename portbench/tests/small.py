"""Small-width runs of the benchmark's cells on the CPU, for the tests."""
import time

from portbench import harness

WIDTH = 64        # symbols a shard here (2^19 on the card)
SEED = 2**31 + 11  # a seed above 32 signed bits, as the driver's may be


def small(cell_name: str, **traffic):
    config, tr = harness.files(cell_name)
    entry = {"name": cell_name, "chips": 1}
    return entry, dict(config, shard_symbols=WIDTH), dict(tr, **traffic)


def run(cell_name: str, seconds: float = 0.5, trace: bool = False,
        seed: int = SEED, install=None, **traffic):
    """(result fields, record) of one small run on the CPU;
    `install(cell)` may put something else in the program's place."""
    t0 = time.perf_counter()
    _, config, tr = small(cell_name, **traffic)
    rec = harness.Record(cell_name, config, tr, seed, seconds, trace=trace)
    cell = harness.driver(tr["kind"]).Cell(config, tr, seed, "cpu", rec)
    if install is not None:
        install(cell)
    out = harness.run_cell(cell, rec, t0, "cpu")
    return out, rec
