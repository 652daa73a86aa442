"""Training-side helpers: observation-time sampling, losses, the optimizer,
step budgets and their elastic recovery, and train steps in chunks with
one host read (``chunk``: one CUDA graph a step on the card)."""
