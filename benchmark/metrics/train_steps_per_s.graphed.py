"""Completed train steps over the whole window (reads, restores and
rollbacks included), by the host's clock; the graphed cells' (their noise
differs: PERF.md section 2)."""

from benchmark import readers

UNIT = "steps/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(rec):
    return readers.steps_per_s(rec)
