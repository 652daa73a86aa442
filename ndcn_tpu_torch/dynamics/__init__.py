"""Ground-truth physics right-hand sides."""

from ndcn_tpu_torch.dynamics.rhs import (DYNAMICS, gene_dynamics,  # noqa: F401
                                         heat_diffusion, make_rhs,
                                         mutualistic_dynamics)
