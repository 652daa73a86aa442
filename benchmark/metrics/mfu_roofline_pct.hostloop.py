"""The whole train step's share of the card's roofline: its least time
(``benchmark.roofline.step``, from one cycle's live NFE, attempts and
accepted attempts) over the window's mean step time."""

from benchmark import readers

LAYER = "train step (train/optim.make_sgd_step)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_steps_per_s.hostloop"


def read(rec):
    return readers.step_roofline_pct(rec)
