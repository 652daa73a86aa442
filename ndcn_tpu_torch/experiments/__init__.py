"""Experiment entry points: the dynamics experiments (``heat``,
``mutualistic``, ``gene``) and the scale experiment (``large_graph``)."""
