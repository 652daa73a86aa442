"""Linear layers with the JAX package's semantics (``ndcn_tpu/models/nn.py``).

Every weight and bias is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
``torch.nn.Linear`` default bound, drawn from an explicit ``torch.Generator``
(never from the global generator).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def linear_init(in_features: int, out_features: int, *,
                generator: torch.Generator) -> nn.Linear:
    """A float32 CPU ``nn.Linear`` drawn from ``generator`` (move it
    afterwards: the same seed then gives the same weights on every device)."""
    layer = nn.utils.skip_init(nn.Linear, in_features, out_features)
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


def linear_apply(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W + b with W (in, out), as the JAX package's ``linear_apply``
    (``nn.Linear`` stores W transposed)."""
    out = x @ layer.weight.t()
    if layer.bias is not None:
        out = out + layer.bias
    return out


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout, as the JAX package's ``dropout``: rate 0 or
    ``deterministic`` is the identity (no draw). The mask is drawn from
    ``generator`` on its own device (the CPU for the drivers' generators)
    and moved to x's, so a card run and a CPU run at one seed drop the same
    elements."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(tuple(x.shape), generator=generator,
                   device=generator.device)
    return torch.where((u < keep).to(x.device), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """A fixed inverted-dropout mask, drawn once per forward from
    ``generator`` (on the generator's device, then moved to ``device``).

    As the JAX package's ``dropout_mask``: the reference resamples dropout at
    every RHS evaluation inside the solver, which makes the ODE stochastic per
    evaluation and the adaptive controller ill-posed; one mask per forward
    keeps the ODE well defined."""
    keep = 1.0 - rate
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return ((u < keep).to(dtype) / keep).to(device)
