"""The host time of the program's ``train.chunk.replay`` spans (each
``graph.replay()``, the launch of the step's CUDA graph) in the traced
window, per traced step (``benchmark.spans.host_ms_per_step``)."""

from benchmark import spans

LAYER = "train loop (train/chunk)"
UNIT = "ms/step"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_steps_per_s.graphed"


def read(rec):
    return spans.host_ms_per_step(rec, "train.chunk.replay")
