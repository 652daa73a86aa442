"""``TrainChunk.capture()`` (its eager warm-up steps and the capture) by
the host's clock, both ends synchronised; graphed cells on the card."""

LAYER = "train loop (train/chunk)"
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec["capture_s"]
