"""Mutualistic-interaction dynamics experiment (reference:
mutualistic_dynamics.py), as ``ndcn_tpu/experiments/mutualistic.py``.

Usage: python -m ndcn_tpu_torch.experiments.mutualistic --niters 100 \\
    --test_freq 20 [--method dopri5] [--sparse [--sparse_format coo]] \\
    [--platform cpu]
"""

from ndcn_tpu_torch.experiments.dynamics import main

if __name__ == "__main__":
    main("mutualistic", "Neural Dynamics on Graphs: Mutualistic Dynamic Case")
