"""The device's idle time under the program's ``train.backward`` spans on
the window's thread (the autograd backward and the gradients' all-reduce),
in percent of the traced window (``benchmark.spans.idle_pct``)."""

from benchmark import spans

LAYER = "model / backward (autograd)"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return spans.idle_pct(rec["trace"], "train.backward")
