"""The device time of the operations launched inside the program's
``ode.solve`` spans on the window's thread (the forward solve: its stages,
step control, RHS and dense output), per traced step
(``benchmark.spans.device_ms_per_step``)."""

from benchmark import spans

LAYER = "solver loop (ode/adaptive)"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return spans.device_ms_per_step(rec, "ode.solve")
