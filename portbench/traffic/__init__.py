"""Traffic: one JSON file of parameters per cell (`<cell>.json`), read by
the generator and driver module its `kind` names (`<kind>.py`)."""
