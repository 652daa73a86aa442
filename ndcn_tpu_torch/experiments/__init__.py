"""Experiment entry points: the heat front of the dynamics experiments."""
