"""encode_roofline_pct.direct (%; device trace): the encode kernels against
their bytes bound, (K + R) * W * 4 bytes at the card's bandwidth (input read
once, parity written once).  Device time is the profiler's kernel time
launched inside the program's `local_encode.*` range of each op."""
from portbench.rooflines import roofline_pct


def read(rec):
    return roofline_pct(rec, ("codeword",), ("local_encode",))
