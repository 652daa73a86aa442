"""ODE solvers on tensors, as ``ndcn_tpu.ode``: dopri5, tsit5, VCABM, the
fixed-grid and fixed-order methods (differentiable and inference solves)
and the continuous adjoint."""

from ndcn_tpu_torch.ode.adaptive import (BatchedSolveStats,  # noqa: F401
                                         SolveStats)
from ndcn_tpu_torch.ode.adjoint import odeint_adjoint  # noqa: F401
from ndcn_tpu_torch.ode.api import (SOLVERS, nan_unless, odeint,  # noqa: F401
                                    odeint_with_stats)
