"""op_mfu_pct.direct (%; host clock): the whole op's share of the chip's
peak: the op's bytes bound (`op_bytes.py`) at the card's bandwidth over the
op's wall time, summed over the window's ops."""
from portbench.peaks import bandwidth


def read(rec):
    if not rec.ops:
        return None
    bound = sum(o["bound_bytes"] for o in rec.ops) / bandwidth(rec.device_kind)
    return 100.0 * bound / sum(o["t1"] - o["t0"] for o in rec.ops)
