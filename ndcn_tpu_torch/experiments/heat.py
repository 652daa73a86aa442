"""Heat-diffusion dynamics experiment (reference: heat_dynamics.py), as
``ndcn_tpu/experiments/heat.py``.

Usage: python -m ndcn_tpu_torch.experiments.heat --network grid --n 400 \\
    --method dopri5 --niters 100 --test_freq 20 [--platform cpu]
"""

from ndcn_tpu_torch.experiments.dynamics import main

if __name__ == "__main__":
    main("heat", "Heat Diffusion Dynamic Case")
