"""The device's idle time under the program's ``ode.solve`` spans on the
window's thread (the forward solve's host loop, the gap after each
``ode.sync`` read included), in percent of the traced window
(``benchmark.spans.idle_pct``)."""

from benchmark import spans

LAYER = "solver loop (ode/adaptive)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return spans.idle_pct(rec["trace"], "ode.solve")
