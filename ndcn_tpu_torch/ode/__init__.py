"""ODE solvers on tensors: ``ndcn_tpu.ode``'s dopri5, differentiable and
inference solves."""

from ndcn_tpu_torch.ode.adaptive import SolveStats  # noqa: F401
from ndcn_tpu_torch.ode.api import SOLVERS, odeint, odeint_with_stats  # noqa: F401
