"""The device time of the operations launched inside the program's
``ode.observe`` spans on the window's thread (the host loop's reads of the
observations: each accepted step's dense output read out and interpolated
at the times it passed, and y0's readout), per traced step
(``benchmark.spans.device_ms_per_step``); None for a program without the
span."""

from benchmark import spans

LAYER = "solver loop (ode/adaptive)"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return spans.device_ms_per_step(rec, "ode.observe")
