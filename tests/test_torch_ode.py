"""The port's dopri5 inference solve against the oracle fixtures and the JAX
package's ``solve_while``.

Trajectories within 1e-4 rel-L1 of the torchdiffeq-oracle fixtures (the JAX
package's own bar); on linear2d and heat_grid400 the same NFE, accepted and
rejected step counts as JAX ``odeint_with_stats(differentiable=False)``,
which the float32 controller arithmetic is there to reproduce.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ndcn_tpu.dynamics import make_rhs as j_make_rhs
from ndcn_tpu.graph.sparse import from_dense as j_from_dense
from ndcn_tpu.ode import odeint_with_stats as j_odeint_with_stats
from ndcn_tpu_torch.dynamics import heat_diffusion
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_dense
from ndcn_tpu_torch.ode import odeint, odeint_with_stats
from ndcn_tpu_torch.ode import tableaux

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
INFER = {"differentiable": False}


def load(name):
    return dict(np.load(os.path.join(FIX, name + ".npz")))


def rel_l1(a, b):
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def heat(op):
    return lambda t, x: heat_diffusion(op, t, x)


def _same_stats(ours, ref):
    assert (ours.nfe, ours.n_accepted, ours.n_rejected, ours.success) == (
        int(ref.nfe), int(ref.n_accepted), int(ref.n_rejected),
        bool(ref.success))
    assert ours.host_syncs == ours.n_accepted + ours.n_rejected


def _linear2d(first_step=None):
    f = load("linear2d_dopri5")
    a = f["a"]
    opts = dict(INFER, **({} if first_step is None
                          else {"first_step": first_step}))
    at = torch.as_tensor(a)
    ours = odeint_with_stats(lambda t, y: y @ at.T, torch.as_tensor(f["y0"]),
                             f["t"], rtol=1e-7, atol=1e-9, method="dopri5",
                             options=opts)
    aj = jnp.asarray(a)
    ref = j_odeint_with_stats(lambda t, y: y @ aj.T, jnp.asarray(f["y0"]),
                              jnp.asarray(f["t"]), rtol=1e-7, atol=1e-9,
                              method="dopri5", options=opts)
    return f, ours, ref


@pytest.mark.parametrize("first_step", [None, 0.01])
def test_linear2d_dopri5_parity_and_step_counts(first_step):
    f, (sol, stats), (_, j_stats) = _linear2d(first_step)
    assert sol.shape == f["sol"].shape
    assert rel_l1(sol.numpy(), f["sol"]) < 1e-4
    _same_stats(stats, j_stats)


def test_heat_grid400_parity_and_step_counts():
    f = load("heat_grid400_dopri5")
    lap = operators.laplacian_dense(generators.build_network("grid", 400))
    sol, stats = odeint_with_stats(heat(from_dense(lap)),
                                   torch.as_tensor(f["x0"]), f["t"],
                                   rtol=1e-7, atol=1e-9, method="dopri5",
                                   options=INFER)
    _, j_stats = j_odeint_with_stats(j_make_rhs("heat", j_from_dense(lap)),
                                     jnp.asarray(f["x0"]), jnp.asarray(f["t"]),
                                     rtol=1e-7, atol=1e-9, method="dopri5",
                                     options=INFER)
    assert rel_l1(sol.numpy(), f["sol"]) < 1e-4
    _same_stats(stats, j_stats)


@pytest.mark.parametrize("net", ["grid", "random", "power_law", "small_world",
                                 "community"])
def test_north_star_heat_parity(net):
    f = load(f"ns_heat_{net}")
    op = from_dense(operators.laplacian_dense(f["adj"]))
    sol = odeint(heat(op), torch.as_tensor(f["x0"]), f["t"],
                 rtol=1e-7, atol=1e-9, method="dopri5", options=INFER)
    assert rel_l1(sol.numpy(), f["sol"]) < 1e-4


def test_decreasing_grid_matches_jax():
    f = load("linear2d_dopri5")
    t = f["t"][::-1].copy()
    at, aj = torch.as_tensor(f["a"]), jnp.asarray(f["a"])
    y0 = f["sol"][-1]
    sol, stats = odeint_with_stats(lambda s, y: y @ at.T, torch.as_tensor(y0),
                                   t, rtol=1e-7, atol=1e-9, method="dopri5",
                                   options=INFER)
    ref, j_stats = j_odeint_with_stats(lambda s, y: y @ aj.T, jnp.asarray(y0),
                                       jnp.asarray(t), rtol=1e-7, atol=1e-9,
                                       method="dopri5", options=INFER)
    np.testing.assert_allclose(sol.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    _same_stats(stats, j_stats)


def test_validation_errors():
    f = torch.zeros(2)

    def rhs(t, y):
        return -y

    with pytest.raises(ValueError, match="unknown method"):
        odeint_with_stats(rhs, f, [0.0, 1.0], method="rk45",
                          options=INFER)
    with pytest.raises(ValueError, match="without specifying `method`"):
        odeint_with_stats(rhs, f, [0.0, 1.0], options=INFER)
    with pytest.raises(ValueError, match="at least 2 points"):
        odeint_with_stats(rhs, f, [0.0], method="dopri5", options=INFER)
    with pytest.raises(ValueError, match="at least 2 points"):
        odeint_with_stats(rhs, f, [[0.0, 1.0]], method="dopri5", options=INFER)
    with pytest.raises(ValueError, match="strictly increasing or decreasing"):
        odeint_with_stats(rhs, f, [0.0, 1.0, 0.5], method="dopri5",
                          options=INFER)
    with pytest.warns(UserWarning, match="unexpected options"):
        odeint_with_stats(rhs, f, [0.0, 1.0], method="dopri5",
                          options=dict(INFER, step_sise=0.1))


@pytest.mark.parametrize("options,shape", [
    ({"emission_dtype": torch.bfloat16}, (3, 4, 2)),   # differentiable default
    ({"emission_readout": lambda y: y.sum(0)}, (3, 2)),
    ({"emission_dtype": torch.bfloat16,
      "emission_readout": lambda y: y[:1]}, (3, 1, 2)),
])
def test_emission_options_run_on_the_differentiable_solve(options, shape):
    """The JAX scan path's emission levers: the same steps as without them,
    observations rounded through bf16 and / or read out."""
    a = torch.tensor([[-0.5, 0.3, 0.0, 0.1], [0.2, -0.4, 0.1, 0.0],
                      [0.0, 0.1, -0.3, 0.2], [0.1, 0.0, 0.2, -0.6]])
    y0 = torch.arange(8.0).reshape(4, 2) / 8.0

    def rhs(t, y):
        return a @ y

    t = [0.0, 0.5, 1.0]
    ref, st = odeint_with_stats(rhs, y0, t, rtol=1e-5, atol=1e-7,
                                method="dopri5")
    out, st2 = odeint_with_stats(rhs, y0, t, rtol=1e-5, atol=1e-7,
                                 method="dopri5", options=options)
    assert out.shape == shape and out.dtype == torch.float32
    assert st2.nfe == st.nfe and st2.success
    readout = options.get("emission_readout", lambda y: y)
    want = torch.stack([readout(r) for r in ref])
    assert float((out - want).abs().max()) <= (
        1e-2 if "emission_dtype" in options else 1e-6)


@pytest.mark.parametrize("method,options,item", [
    ("tsit5", None, "item 5"),                        # differentiable default
    ("tsit5", INFER, "item 5"),
    ("fixed_adams", INFER, "item 5"),                 # euler is ported
    ("adams", INFER, "item 5"),
    ("dopri5", dict(INFER, time_dtype="float64"), "item 5"),
])
def test_unported_paths_name_their_roadmap_item(method, options, item):
    """These paths raised naming ROADMAP ``item`` until that item (the
    remaining solvers) was ported; now each solves dy/dt = -y."""
    t = np.linspace(0.0, 1.0, 11)
    sol, stats = odeint_with_stats(lambda t, y: -y, torch.ones(3), t,
                                   method=method, options=options)
    assert stats.success and sol.shape == (11, 3)
    assert sol.dtype == torch.float32
    assert float((sol[-1] - np.exp(-1.0)).abs().max()) <= 1e-3


def test_step_budget_runs_out_loudly():
    y0 = torch.ones(4)
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)

    def rhs(t, y):
        return y ** 2 + 1.0  # blows up in finite time

    sol, stats = odeint_with_stats(rhs, y0, t, rtol=1e-6, atol=1e-8,
                                   method="dopri5",
                                   options=dict(INFER, max_steps=6))
    assert stats.success is False
    assert stats.n_accepted + stats.n_rejected == 6
    assert torch.isnan(odeint(rhs, y0, t, rtol=1e-6, atol=1e-8,
                              method="dopri5",
                              options=dict(INFER, max_steps=6))).all()
    assert torch.equal(sol[0], y0)


def test_tableau_check_rejects_malformed():
    tableaux._check(tableaux.DOPRI5)
    bad = tableaux.DOPRI5._replace(beta=tableaux.DOPRI5.beta[:-1] + ((1.0,),))
    with pytest.raises(ValueError, match="beta row"):
        tableaux._check(bad)
    with pytest.raises(ValueError, match="stage counts"):
        tableaux._check(tableaux.DOPRI5._replace(c_error=(1.0,)))
