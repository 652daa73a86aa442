"""The port's continuous adjoint (``ode.adjoint``) on the CPU, against the
torchdiffeq-oracle fixtures, backprop and the JAX package's
``odeint_adjoint``.

Bars:
- ``ndcn_grads_grid400``'s adjoint half (the reference's ``--adjoint``
  gradients): loss within 1e-4 relative, every gradient within 1e-3
  rel-L1, on the dense (K2 where 'auto' fuses), COO (K1, K1 over the
  transpose CSR in the VJPs) and BSR (K3, K4) routes, plain versions; no
  NaN reaches a gradient (the kernels give NaN for an operator cotangent,
  which the VJPs never request);
- ``ndcn_grads_random60_{gene,mutualistic}``'s adjoint halves: loss and
  decoder gradients 1e-4, the rest 2e-2, the gradient-parity floor of
  docs/PARITY.md;
- the JAX package's ``odeint_adjoint`` through ``ndcn_forward(adjoint=True)``
  on the same weights (``convert.params_from_jax``): 1e-4 rel-L1, with the
  same forward steps;
- backprop through a tight solve of a linear system: 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.ode.adjoint import odeint_adjoint as j_odeint_adjoint
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import odeint_with_stats
from ndcn_tpu_torch.ode.adjoint import (odeint_adjoint,
                                        odeint_adjoint_with_stats)
from ndcn_tpu_torch.train.losses import l1_loss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAYERS = ("enc1", "enc2", "wt", "dec")
KW = dict(rtol=0.01, atol=0.001, method="dopri5")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of small tensor operations: one thread runs them faster
    than a pool that shares the cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    return dict(np.load(os.path.join(FIX, name + ".npz")))


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _fixture_model(f):
    return params_from_jax({n: {"w": f[f"{n}_w"].T, "b": f[f"{n}_b"]}
                            for n in LAYERS})


def _grads(model):
    return {n: (getattr(model, n).weight.grad, getattr(model, n).bias.grad)
            for n in LAYERS}


@pytest.mark.parametrize("fmt,fused", [("dense", "auto"), ("coo", False),
                                       ("bsr", False), ("bsr", True)])
def test_adjoint_gradients_meet_the_grid400_fixture(fmt, fused):
    f = load("ndcn_grads_grid400")
    lap = operators.normalized_laplacian(generators.build_network("grid",
                                                                  400))
    model = _fixture_model(f)
    op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                     sparse=fmt != "dense",
                     format="coo" if fmt == "dense" else fmt)
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              max_steps=64, fused=fused, adjoint=True, **KW)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert stats.success and stats.nfe == 20
    back = stats.backward
    assert len(back) == len(f["t"]) - 1 and all(s.success for s in back)
    ref = float(f["loss_adjoint"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name, (gw, gb) in _grads(model).items():
        assert torch.isfinite(gw).all() and torch.isfinite(gb).all()
        assert rel_l1(gw, f[f"g_{name}_w_adjoint"]) < 1e-3, name
        assert rel_l1(gb, f[f"g_{name}_b_adjoint"]) < 1e-3, name


@pytest.mark.parametrize("dyn", ["gene", "mutualistic"])
def test_adjoint_gradients_meet_the_random60_fixtures(dyn):
    f = load(f"ndcn_grads_random60_{dyn}")
    model = _fixture_model(f)
    op = as_operator(operators.normalized_laplacian(f["adj"]))
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              max_steps=64, adjoint=True, **KW)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert stats.success
    ref = float(f["loss_adjoint"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name, (gw, gb) in _grads(model).items():
        tol = 1e-4 if name == "dec" else 2e-2
        assert rel_l1(gw, f[f"g_{name}_w_adjoint"]) < tol, name
        assert rel_l1(gb, f[f"g_{name}_b_adjoint"]) < tol, name


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "adams"])
def test_adjoint_matches_backprop_on_a_linear_system(method):
    """dy/dt = k·A y at a tight tolerance: the continuous adjoint's
    gradients for k and y0 against backprop through dopri5's solve (VCABM's
    own backprop goes through its order controller and is far from the
    ODE's gradient, ``tests/test_torch_solvers.py``). 1e-4; 5e-3 for VCABM,
    whose adjoint at this tolerance is 1.7e-3 off in float64 as well (it
    reports the predictor, and its error control holds the corrector)."""
    rs = np.random.RandomState(0)
    a = torch.as_tensor(rs.randn(4, 4).astype(np.float32)) * 0.5
    weights = torch.as_tensor(rs.randn(7, 4, 2).astype(np.float32))
    t = np.linspace(0.0, 2.0, 7).astype(np.float32)

    def grads(adjoint):
        k = torch.tensor(0.7, requires_grad=True)
        y0 = torch.ones(4, 2, requires_grad=True)

        def rhs(tt, y):
            return k * (a @ y)

        kw = dict(rtol=1e-7, atol=1e-9)
        sol = (odeint_adjoint(rhs, y0, t, (k,), method=method, **kw)
               if adjoint else
               odeint_with_stats(rhs, y0, t, method="dopri5",
                                 options={"max_steps": 512}, **kw)[0])
        (sol * weights).sum().backward()
        return sol.detach(), k.grad, y0.grad

    sol_a, k_a, y_a = grads(True)
    sol_b, k_b, y_b = grads(False)
    bar = 5e-3 if method == "adams" else 1e-4
    assert rel_l1(sol_a, sol_b) < 1e-4
    assert abs(float(k_a) - float(k_b)) <= bar * abs(float(k_b))
    assert rel_l1(y_a, y_b) < bar


@pytest.mark.parametrize("method,sparse_format", [
    ("dopri5", None), ("dopri5", "coo"), ("tsit5", None), ("euler", None),
    ("adams", None)])
def test_adjoint_matches_the_jax_package(method, sparse_format):
    """``ndcn_forward(adjoint=True)`` of both packages on the same weights
    and inputs (a 36-node grid): the same forward steps, gradients within
    1e-4 rel-L1; tsit5's within 1e-3, the fixture's bar, since its
    embedded error cancels (its weights sum to zero) and the backward
    solves of the two packages can take different steps at rtol 0.01."""
    lap = operators.normalized_laplacian(generators.build_network("grid", 36))
    j_params = j_init_ndcn(jax.random.PRNGKey(3), 1, 8, 1)
    x0 = np.random.RandomState(1).uniform(0.0, 5.0, (36, 1)).astype(
        np.float32)
    t = np.linspace(0.0, 1.5, 6).astype(np.float32)
    target = np.random.RandomState(2).rand(6, 36, 1).astype(np.float32)
    kw = dict(rtol=0.01, atol=0.001, method=method, adjoint=True,
              max_steps=64)
    sparse = sparse_format is not None

    def j_loss(p):
        out, _ = j_ndcn_forward(p, j_as_operator(lap, sparse=sparse,
                                                 format=sparse_format or "coo"),
                                jnp.asarray(t), jnp.asarray(x0), **kw)
        return jnp.mean(jnp.abs(out - target))

    j_val, j_grads = jax.value_and_grad(j_loss)(j_params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    op = as_operator(sp.csr_matrix(lap) if sparse else lap, sparse=sparse,
                     format=sparse_format or "coo")
    out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0), **kw)
    loss = (out - torch.as_tensor(target)).abs().mean()
    loss.backward()
    assert stats.success
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    bar = 1e-3 if method == "tsit5" else 1e-4
    for n in LAYERS:
        assert rel_l1(getattr(model, n).weight.grad.numpy().T,
                      j_grads[n]["w"]) < bar, n
        assert rel_l1(getattr(model, n).bias.grad, j_grads[n]["b"]) < bar


def test_adjoint_runs_the_ablations_and_dropout():
    """no_control (no parameters in the RHS: only the encoder and decoder
    get gradients) and dropout (a fixed mask in the RHS) under the
    adjoint, against backprop."""
    lap = operators.normalized_laplacian(generators.build_network("grid", 25))
    op = as_operator(lap)
    x0 = torch.as_tensor(np.random.RandomState(0).rand(25, 1)
                         .astype(np.float32))
    t = np.linspace(0.0, 1.0, 5).astype(np.float32)
    for kwargs in (dict(no_control=True), dict(dropout=0.2)):
        grads = []
        for adjoint in (True, False):
            model = params_from_jax(jax.tree_util.tree_map(
                np.asarray, j_init_ndcn(jax.random.PRNGKey(0), 1, 6, 1)))
            rng = torch.Generator().manual_seed(4)
            out, stats = ndcn_forward(model, op, t, x0, rtol=1e-6, atol=1e-8,
                                      method="dopri5", adjoint=adjoint,
                                      rng=rng, max_steps=256, **kwargs)
            out.square().mean().backward()
            assert stats.success
            grads.append(np.concatenate([p.grad.numpy().ravel()
                                         for p in model.parameters()
                                         if p.grad is not None]))
        assert grads[0].shape == grads[1].shape
        assert rel_l1(grads[0], grads[1]) < 1e-3, kwargs


def test_adjoint_budget_runs_out_loudly():
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    k = torch.tensor(1.0, requires_grad=True)
    sol, stats = odeint_adjoint_with_stats(
        lambda tt, y: k * y ** 2 + 1.0, torch.ones(4), t, (k,), rtol=1e-6,
        atol=1e-8, method="dopri5", options={"max_steps": 6})
    assert stats.success is False and torch.isnan(sol).all()


def test_adjoint_with_float64_time_matches_the_float32_solve():
    """time_dtype reaches the forward and the backward solves; the state and
    the gradients stay float32."""
    a = torch.tensor([[-0.5, 0.2], [0.1, -0.3]])
    t = np.linspace(0.0, 1.0, 4).astype(np.float32)
    out = []
    for opts in (None, {"time_dtype": "float64"}):
        k = torch.tensor(1.0, requires_grad=True)
        sol = odeint_adjoint(lambda tt, y: k * (a @ y), torch.ones(2), t,
                             (k,), rtol=1e-6, atol=1e-8, method="dopri5",
                             options=opts)
        sol.sum().backward()
        assert sol.dtype == torch.float32 and k.grad.dtype == torch.float32
        out.append(float(k.grad))
    assert abs(out[0] - out[1]) <= 1e-5 * abs(out[0])


def test_jax_adjoint_on_the_same_linear_system():
    """``odeint_adjoint`` against the JAX package's on y' = k·A y."""
    a = np.array([[-0.5, 0.2, 0.0], [0.1, -0.3, 0.2], [0.0, 0.3, -0.4]],
                 np.float32)
    t = np.linspace(0.0, 2.0, 5).astype(np.float32)
    y0 = np.array([1.0, 0.5, -0.2], np.float32)
    k = torch.tensor(0.9, requires_grad=True)
    y = torch.as_tensor(y0).requires_grad_()
    at = torch.as_tensor(a)
    sol = odeint_adjoint(lambda tt, yy: k * (at @ yy), y, t, (k,),
                         rtol=1e-6, atol=1e-8, method="dopri5")
    (sol ** 2).sum().backward()
    aj = jnp.asarray(a)

    def j_loss(kk, yy):
        s = j_odeint_adjoint(lambda tt, z, p: p * (aj @ z), yy,
                             jnp.asarray(t), kk, rtol=1e-6, atol=1e-8,
                             method="dopri5")
        return jnp.sum(s ** 2)

    gk, gy = jax.grad(j_loss, argnums=(0, 1))(jnp.float32(0.9),
                                              jnp.asarray(y0))
    assert abs(float(k.grad) - float(gk)) <= 1e-5 * abs(float(gk))
    assert rel_l1(y.grad, gy) < 1e-5
