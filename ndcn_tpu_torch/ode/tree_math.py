"""The state algebra the solver needs, on plain tensors.

The JAX package works on pytrees (``ndcn_tpu/ode/tree_math.py``); the port's
ODE state is one tensor, so only the RMS norm and the weighted stage sums
remain.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor) -> torch.Tensor:
    """||x||_2 / sqrt(numel), as the reference ``_norm``."""
    return torch.sqrt(torch.sum(torch.square(x)) / x.numel())


def scaled_dot_product(scale: torch.Tensor, coeffs: torch.Tensor,
                       stacked: torch.Tensor) -> torch.Tensor:
    """scale * sum_i coeffs[i] * stacked[i] along the leading stage axis;
    ``coeffs`` is a 1-D tensor of len <= stacked.shape[0]."""
    return scale * torch.tensordot(coeffs, stacked[: coeffs.shape[0]], dims=1)
