"""Experiment entry points: the dynamics experiments (``heat``,
``mutualistic``, ``gene``), the scale experiment (``large_graph``), node
classification (``dgnn``, ``train_gcn``, ``train_resgcn``), the T × alpha
sweep (``sweep_t_alpha``), the Lotka-Volterra demo (``lv``) and
``summarize``."""
