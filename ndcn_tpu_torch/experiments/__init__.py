"""Experiment entry points: the heat front of the dynamics experiments
(``heat``) and the scale experiment (``large_graph``)."""
