"""The bounded VCABM solve (``ode.vcabm.solve_vcabm_scan``, adams under the
solve's ``scan`` option) and the fixed-grid Adams methods under ``scan``
on the CPU, against the JAX package and the port's host loop.

Bars:
- against JAX's ``solve_vcabm_scan`` on a float64 state (linear2d_adams,
  where the order controller's error estimates carry no float32 noise):
  counts equal, the solution within 1e-8 and the gradients for A and y0
  within 1e-6 rel-L1;
- on the grid400 NDCN at float32: the loss within 1e-5, the gradients
  within 1e-4 rel-L1 and NFE equal;
- against the host loop (``vcabm.solve_vcabm``): counts equal and the
  solution within 1e-6 at float32 (the masked sums may round apart in the
  last bit); the gradients within 1e-10 on a float64 state (at float32 the
  gradient through the step and order controller reads error estimates at
  rounding level, and the two orders of summation part by ~1e-3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.graph.sparse import from_dense as j_from_dense
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.ode import odeint_with_stats as j_odeint_with_stats
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.experiments.dynamics import nan_unless_ok
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import fixed_adams, odeint, odeint_with_stats
from ndcn_tpu_torch.train.losses import l1_loss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAYERS = ("enc1", "enc2", "wt", "dec")
SCAN = {"scan": True}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small tensor operations: one thread runs them faster than a
    pool that shares the cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _stats(s):
    return tuple(int(x) for x in s[:3]) + (bool(s.success),)


@pytest.mark.parametrize("rtol", [1e-3, 1e-4])
def test_bounded_adams_matches_jax_solve_vcabm_scan_on_a_float64_state(rtol):
    """linear2d_adams (y' = y Aᵀ over 25 points, 73 attempts) on a float64
    state and grid: the port's bounded solve takes the attempts of JAX's
    ``solve_vcabm_scan``; the solution and its gradient for A and y0
    agree (1e-13 here). At rtol 1e-5, where two attempts are rejected, the
    counts and the solution agree too but the gradient for A is 1.6e-6
    off JAX's, in the port's host loop as much as here (the two port
    solves agree to 4e-11): ROADMAP §3."""
    f = dict(np.load(os.path.join(FIX, "linear2d_adams.npz")))
    a64, y64, t64 = (f[k].astype(np.float64) for k in ("a", "y0", "t"))
    w = np.random.RandomState(0).randn(*f["sol"].shape)
    a = torch.tensor(a64, requires_grad=True)
    y0 = torch.tensor(y64, requires_grad=True)
    opts = {"time_dtype": "float64", "max_steps": 80}
    sol, st = odeint_with_stats(lambda t, y: y @ a.T, y0, t64, rtol=rtol,
                                atol=rtol / 100, method="adams",
                                options=dict(SCAN, **opts))
    (sol * torch.as_tensor(w)).sum().backward()
    with jax.enable_x64(True):
        def j_loss(aj, yj):
            s, jst = j_odeint_with_stats(lambda t, y: y @ aj.T, yj,
                                         jnp.asarray(t64), rtol=rtol,
                                         atol=rtol / 100, method="adams",
                                         options=opts)
            return jnp.sum(s * w), (s, jst)

        (_, (j_sol, j_st)), (ga, gy) = jax.value_and_grad(
            j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(a64),
                                                  jnp.asarray(y64))
        j_sol, ga, gy = (np.asarray(x) for x in (j_sol, ga, gy))
        j_st = _stats(j_st)
    assert isinstance(st.nfe, torch.Tensor) and st.host_syncs == 0
    assert _stats(st) == j_st and j_st[3]
    assert rel_l1(sol.detach(), j_sol) <= 1e-8
    assert rel_l1(a.grad, ga) <= 1e-6 and rel_l1(y0.grad, gy) <= 1e-6


def test_bounded_adams_matches_jax_on_the_grid400_ndcn():
    """The grid400 NDCN (hidden 20, dense operator, K2's plain version)
    through the bounded adams solve against JAX's ``ndcn_forward`` (its
    ``solve_vcabm_scan``) at float32: NFE equal, the loss within 1e-5 and
    every gradient within 1e-4 rel-L1."""
    f = dict(np.load(os.path.join(FIX, "ndcn_grads_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in LAYERS}
    lap = operators.normalized_laplacian(generators.build_network("grid",
                                                                  400))
    kw = dict(rtol=0.01, atol=0.001, method="adams", max_steps=24)

    def j_loss(p):
        out, stats = j_ndcn_forward(p, j_from_dense(lap), jnp.asarray(f["t"]),
                                    jnp.asarray(f["x0"]), **kw)
        return jnp.mean(jnp.abs(out[..., 0].T - f["target"])), stats

    (j_val, j_st), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = params_from_jax(tree)
    out, st = ndcn_forward(model, as_operator(lap), torch.as_tensor(f["t"]),
                           torch.as_tensor(f["x0"]), fused="auto",
                           scan=True, **kw)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert _stats(st) == _stats(j_st) and bool(st.success)
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    for n in LAYERS:
        layer = getattr(model, n)
        assert rel_l1(layer.weight.grad.numpy().T, j_grads[n]["w"]) <= 1e-4
        assert rel_l1(layer.bias.grad, j_grads[n]["b"]) <= 1e-4


def _decay_problem(dtype):
    rs = np.random.RandomState(1)
    a = torch.as_tensor(rs.randn(6, 6).astype(dtype)) * 0.5
    t = np.linspace(0.0, 2.0, 9).astype(dtype)
    return a, t


@pytest.mark.parametrize("differentiable", [True, False])
def test_bounded_adams_matches_the_host_loop(differentiable):
    """The bounded solve against ``solve_vcabm`` on one float32 input: the
    same attempts, the solution within 1e-6; the differentiable solve's
    gradient within 1e-10 of the host loop's on the float64 state."""
    for dtype in (np.float32, np.float64):
        a, t = _decay_problem(dtype)
        tdt = {"time_dtype": "float64"} if dtype == np.float64 else {}

        def solve(options):
            scale = torch.tensor(1.0, dtype=a.dtype, requires_grad=True)
            y0 = torch.ones(6, 2, dtype=a.dtype, requires_grad=True)
            with torch.set_grad_enabled(differentiable):
                sol, st = odeint_with_stats(
                    lambda tt, y: scale * (a @ y), y0, t, rtol=1e-5,
                    atol=1e-7, method="adams",
                    options=dict(options, max_steps=40,
                                 differentiable=differentiable, **tdt))
            grads = (None, None)
            if differentiable:
                (sol * torch.linspace(-1.0, 1.0, 9, dtype=a.dtype)[
                    :, None, None]).sum().backward()
                grads = scale.grad, y0.grad
            return sol.detach(), st, grads

        sol, st, (g_s, g_y) = solve(SCAN)
        ref, st_ref, (r_s, r_y) = solve({})
        assert st.host_syncs == 0 and st_ref.host_syncs > 0
        assert _stats(st) == _stats(st_ref)
        assert rel_l1(sol, ref) <= 1e-6
        if differentiable and dtype == np.float64:
            assert rel_l1(g_s, r_s) <= 1e-10 and rel_l1(g_y, r_y) <= 1e-10


def test_bounded_adams_budget_runs_out_loudly():
    """A blown budget: exactly ``max_steps`` attempts, ``success`` false on
    the device, zeros where the JAX package leaves them (``odeint`` turns
    the trajectory to NaN) and a NaN loss whose backward gives a zero
    gradient."""
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    y0 = torch.ones(4, requires_grad=True)
    sol, stats = odeint_with_stats(lambda tt, y: y ** 2 + 1.0, y0, t,
                                   rtol=1e-6, atol=1e-8, method="adams",
                                   options=dict(SCAN, max_steps=6))
    assert not bool(stats.success)
    assert int(stats.n_accepted) + int(stats.n_rejected) == 6
    assert int(stats.nfe) == 2 + 2 * 6
    assert torch.equal(sol[-1].detach(), torch.zeros(4))
    loss = nan_unless_ok(stats.success, sol.sum())
    assert torch.isnan(loss)
    loss.backward()
    assert torch.equal(y0.grad, torch.zeros(4))
    assert torch.isnan(odeint(lambda tt, y: y ** 2 + 1.0, torch.ones(4), t,
                              rtol=1e-6, atol=1e-8, method="adams",
                              options=dict(SCAN, max_steps=6))).all()


def test_bounded_adams_survives_an_overflowing_attempt():
    """y' = s·y, whose RHS is inf wherever the state runs 2% past the true
    solution: one attempt's predictor does, goes non-finite and is
    rejected. Its recomputation as the forced rejection keeps the gradient
    finite and within 1e-9 of the host loop's, which records the forced
    rejection in the first place (a float64 state: at float32 the gradient
    through the order controller carries ~1e-5 of rounding); the counts
    are equal."""
    t = np.linspace(0.0, 3.0, 6)
    out = []
    for options in (SCAN, {}):
        scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)

        def f(tt, y):
            return scale * y + torch.where(y > 1.02 * torch.exp(tt),
                                           float("inf"), 0.0)

        sol, st = odeint_with_stats(
            f, torch.ones(3, dtype=torch.float64), t, rtol=1e-3, atol=1e-6,
            method="adams", options=dict(options, max_steps=64,
                                         time_dtype="float64"))
        sol.sum().backward()
        out.append((st, float(scale.grad)))
    (st_scan, g_scan), (st_host, g_host) = out
    assert _stats(st_scan) == _stats(st_host) and bool(st_scan.success)
    assert int(st_scan.n_rejected) >= 1
    assert np.isfinite(g_scan) and abs(g_scan - g_host) <= 1e-9 * abs(g_host)


@pytest.mark.parametrize("method", ["explicit_adams", "fixed_adams"])
def test_fixed_adams_on_the_device_grid_copy_nothing(method):
    """The fixed-grid Adams methods under ``scan`` with the grid as a
    tensor (what a CUDA graph reads): their tables are made once a device
    and shared, so a second solve copies nothing from the host, and the
    answer is the host grid's, bit for bit."""
    a, t = _decay_problem(np.float32)
    sol_host, _ = odeint_with_stats(lambda tt, y: a @ y, torch.ones(6, 2), t,
                                    method=method)
    tables = fixed_adams._tables(torch.device("cpu"))
    sol, st = odeint_with_stats(lambda tt, y: a @ y, torch.ones(6, 2),
                                torch.as_tensor(t), method=method,
                                options=SCAN)
    assert all(x is y for x, y in zip(fixed_adams._tables(
        torch.device("cpu")), tables))
    assert torch.equal(sol, sol_host) and st.success
