"""Process start to the window's first step, by the host's clock: imports,
inputs, the operator, the probe, the first cycle, a graph's capture."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(rec):
    return rec["setup_s"]
