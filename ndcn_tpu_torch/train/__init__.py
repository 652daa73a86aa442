"""Training-side helpers: observation-time sampling, losses, the optimizer,
step budgets and their elastic recovery."""
