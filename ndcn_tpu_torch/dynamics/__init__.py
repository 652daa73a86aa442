"""Ground-truth physics right-hand sides."""

from ndcn_tpu_torch.dynamics.rhs import heat_diffusion  # noqa: F401
