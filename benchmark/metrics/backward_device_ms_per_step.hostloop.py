"""The device time of the operations in the traced window that no event
of the window's thread launched: the autograd engine's device thread, the
backward of the eager step. Per traced step; read only where the program
opens ``train.backward`` spans
(``benchmark.spans.other_thread_device_ms_per_step``)."""

from benchmark import spans

LAYER = "model / backward (autograd)"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return spans.other_thread_device_ms_per_step(rec, "train.backward")
