"""The share of the traced window in which no operation ran on the device:
1 - (the union of the device operations' intervals) / the window."""

from benchmark import readers

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return readers.idle_pct(rec)
