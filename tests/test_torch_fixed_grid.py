"""The fixed-grid solvers of the port (euler, midpoint, rk4) on the CPU,
against the torchdiffeq-oracle fixtures and the JAX package.

Bars, the JAX package's own (``tests/test_parity.py``,
``tests/test_gradients.py``):
- ``decay_{euler,midpoint,rk4}``: 1e-4 rel-L1;
- ``step_size`` interpolation against ``ndcn_tpu.ode.fixed_grid``: 1e-6
  (the same float32 steps);
- ``ndcn_grads_grid400_euler``: loss within 1e-4 relative, every gradient
  within 1e-3 rel-L1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.ode import odeint_with_stats as j_odeint_with_stats
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_dense
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import odeint_with_stats
from ndcn_tpu_torch.train.losses import l1_loss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAYERS = ("enc1", "enc2", "wt", "dec")
METHODS = ("euler", "midpoint", "rk4")


def load(name):
    return dict(np.load(os.path.join(FIX, name + ".npz")))


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


@pytest.mark.parametrize("method", METHODS)
def test_fixed_grid_matches_the_oracle_on_decay(method):
    f = load(f"decay_{method}")
    sol, stats = odeint_with_stats(lambda t, y: -y, torch.as_tensor(f["y0"]),
                                   f["t"], method=method)
    assert rel_l1(sol, f["sol"]) < 1e-4
    steps = len(f["t"]) - 1
    assert stats.success and stats.n_accepted == steps
    assert stats.nfe == steps * {"euler": 1, "midpoint": 2, "rk4": 4}[method]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("step_size", [0.07, 0.5])
def test_step_size_interpolates_as_the_jax_package(method, step_size):
    """A finer (0.07) and a coarser (0.5) grid than the observations, on an
    irregular grid and a 2-d linear system: the observations are linear
    interpolations between the bracketing grid states (the JAX package's
    fix of the reference's right-endpoint value), NFE and steps equal."""
    t = np.array([0.0, 0.13, 0.4, 0.41, 1.0, 1.7, 2.0], np.float32)
    a = np.array([[-0.5, 1.0], [-1.0, -0.3]], np.float32)
    y0 = np.array([1.0, -0.5], np.float32)
    ref, j_stats = j_odeint_with_stats(
        lambda tt, y: y @ jnp.asarray(a).T, jnp.asarray(y0), jnp.asarray(t),
        method=method, options={"step_size": step_size})
    a_t = torch.as_tensor(a)
    sol, stats = odeint_with_stats(lambda tt, y: y @ a_t.T,
                                   torch.as_tensor(y0), t, method=method,
                                   options={"step_size": step_size})
    np.testing.assert_allclose(sol.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert stats.nfe == int(j_stats.nfe)
    assert stats.n_accepted == int(j_stats.n_accepted)


def test_fixed_grid_reverse_time_options_and_no_grad():
    """A decreasing grid integrates backwards; the common options are
    accepted and ignored, an unknown one warns; differentiable=False records
    nothing."""
    y0 = torch.ones(3, requires_grad=True)
    fwd, _ = odeint_with_stats(lambda t, y: -y, y0, [0.0, 0.5, 1.0],
                               method="rk4")
    back, _ = odeint_with_stats(lambda t, y: -y, fwd[-1], [1.0, 0.5, 0.0],
                                method="rk4", options={"max_steps": 4})
    # there and back by two rk4 steps of 0.5 each way: ~5e-4 of truncation
    np.testing.assert_allclose(back[-1].detach().numpy(), np.ones(3),
                               rtol=1e-3)
    assert float(back[1, 0]) == pytest.approx(float(fwd[1, 0]), rel=1e-3)
    with pytest.warns(UserWarning, match="unexpected options"):
        odeint_with_stats(lambda t, y: -y, y0, [0.0, 1.0], method="euler",
                          options={"rtol": 1.0})
    sol, _ = odeint_with_stats(lambda t, y: -y, y0, [0.0, 1.0],
                               method="midpoint",
                               options={"differentiable": False})
    assert not sol.requires_grad and fwd.requires_grad


def test_euler_gradients_match_the_oracle_fixture():
    """The flagship l1 loss down the euler path (the dynamics scripts'
    default): fixed steps on the observation grid, gradients by backprop
    through them, at the fixture's weights."""
    f = load("ndcn_grads_grid400_euler")
    model = params_from_jax({name: {"w": f[f"{name}_w"].T,
                                    "b": f[f"{name}_b"]} for name in LAYERS})
    op = from_dense(operators.normalized_laplacian(
        generators.build_network("grid", 400)))
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              method="euler")
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert stats.success and stats.nfe == len(f["t"]) - 1
    ref = float(f["loss_backprop"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name in LAYERS:
        layer = getattr(model, name)
        assert rel_l1(layer.weight.grad, f[f"g_{name}_w_backprop"]) < 1e-3
        assert rel_l1(layer.bias.grad, f[f"g_{name}_b_backprop"]) < 1e-3
