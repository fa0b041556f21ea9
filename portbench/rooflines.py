"""The kernels' roofline share, shared by the `*_roofline_pct` readers."""
from portbench.peaks import bandwidth


def roofline_pct(rec, ops: tuple[str, ...], legs: tuple[str, ...]):
    """Bytes bound over device time: for each benchmark op of `ops`, the
    kernel time (profiler) launched inside the program's ranges named
    `legs` within it, against the op's bytes at the card's bandwidth."""
    dt = rec.device
    if dt is None:
        return None
    by_i = {o["i"]: o for o in rec.ops}
    bound = device = 0.0
    for r in dt.ranges:
        name, _, i = r["name"].partition("#")
        if not name.startswith("bench.") or name[6:] not in ops:
            continue
        inner = [x for x in dt.ranges
                 if x["name"].startswith(legs) and x["ts"] >= r["ts"]
                 and x["ts"] + x["dur"] <= r["ts"] + r["dur"]]
        t = sum(k["dur"] for x in inner for k in dt.launched_in(x))
        if t > 0 and int(i) in by_i:
            device += t / 1e6
            bound += by_i[int(i)]["bound_bytes"] / bandwidth(rec.device_kind)
    return 100.0 * bound / device if device > 0 else None
