"""Kernels the device ran in the traced window, per train step."""

from benchmark import readers

LAYER = "device (H100)"
UNIT = "launches/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return readers.launches_per_step(rec)
