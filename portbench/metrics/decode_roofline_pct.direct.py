"""decode_roofline_pct.direct (%; device trace): the decode kernels against
their bytes bound: K survivor rows read, plus the erased data rows (`read`)
or every erased row (`rebuild`) written, 4 bytes a symbol, at the card's
bandwidth.  Device time is the profiler's kernel time launched inside the
program's `local_data` (read) and `local_decode` (rebuild) ranges."""
from portbench.rooflines import roofline_pct


def read(rec):
    return roofline_pct(rec, ("read", "rebuild"),
                        ("local_data", "local_decode"))
