"""RHS evaluations a train step's solve makes (``SolveStats.nfe``: live
evaluations only), the mean over one cycle read a step a call."""

from benchmark import readers

LAYER = "solver loop (ode/adaptive)"
UNIT = "nfe/step"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_steps_per_s.graphed"


def read(rec):
    return readers.nfe_per_step(rec)
