"""Training-side helpers; this slice ports the observation-time sampling."""
