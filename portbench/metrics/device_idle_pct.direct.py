"""device_idle_pct.direct (%; device trace): the share of the traced window
in which no kernel and no copy ran on the card (profiler timeline), in the
cells that report `data_gbps`."""


def read(rec):
    return rec.device.idle_pct() if rec.device is not None else None
