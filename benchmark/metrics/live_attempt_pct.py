"""The share of the bounded solve's ``max_steps`` attempts that are live
(accepted + rejected; the rest run masked at dt = 0), the mean over one
cycle. Only the bounded solve has masked attempts."""

LAYER = "solver loop (ode/adaptive)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "train_steps_per_s.graphed"


def read(rec):
    counts = rec["counts"]
    if not counts or rec["traffic"]["dispatch"] != "graphed":
        return None
    return 100.0 * sum(c[1] + c[2] for c in counts) / (
        len(counts) * rec["max_steps"])
