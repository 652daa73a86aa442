"""Gene-regulation dynamics experiment (reference: gene_dynamics.py), as
``ndcn_tpu/experiments/gene.py``.

Usage: python -m ndcn_tpu_torch.experiments.gene --niters 100 \\
    --test_freq 20 [--method dopri5] [--sparse [--sparse_format coo]] \\
    [--platform cpu]
"""

from ndcn_tpu_torch.experiments.dynamics import main

if __name__ == "__main__":
    main("gene", "Gene Regulation Dynamic Case")
