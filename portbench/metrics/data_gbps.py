"""data_gbps (GB/s, higher is better; host clock): user data coded per
second.  Every op completed in the window counts its stripe's user data,
K * W * 2 bytes, whatever the op; the sum is divided by the time from the
window's start to the end of its last op (the op in flight at the deadline
completes and counts)."""


def read(rec):
    if not rec.ops:
        return None
    end = max(o["t1"] for o in rec.ops)
    return sum(o["user_bytes"] for o in rec.ops) / (end - rec.window_start) / 1e9
