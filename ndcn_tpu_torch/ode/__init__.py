"""ODE solvers on tensors: the dopri5 inference solve of ``ndcn_tpu.ode``."""

from ndcn_tpu_torch.ode.adaptive import SolveStats  # noqa: F401
from ndcn_tpu_torch.ode.api import SOLVERS, odeint, odeint_with_stats  # noqa: F401
