"""The continuous adjoint under the solve's ``scan`` option (``ode.adjoint``
on the bounded inference solve: what a CUDA graph of a train step records)
on the CPU, against the port's host-loop adjoint, the
``ndcn_grads_grid400`` fixture and the JAX package's ``odeint_adjoint``.

Bars:
- against the host-loop adjoint: the forward's and every backward
  interval's stats equal, the loss and the gradients bit-equal (the
  bounded inference solve evaluates each observation as the host loop
  does);
- ``ndcn_grads_grid400``'s adjoint half: loss 1e-4, gradients 1e-3 rel-L1
  (the fixture's own bars);
- the JAX package's ``odeint_adjoint`` through ``ndcn_forward``: the loss
  within 1e-5, the gradients within 1e-3 rel-L1.
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
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode.adjoint import odeint_adjoint_with_stats
from ndcn_tpu_torch.train.losses import l1_loss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAYERS = ("enc1", "enc2", "wt", "dec")


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


def _grads(model):
    return [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("fmt,fused", [("dense", "auto"), ("coo", False),
                                       ("bsr", True)])
def test_bounded_adjoint_meets_the_grid400_fixture_and_the_host_loop(
        fmt, fused):
    """The grid400 NDCN's adjoint step on each operator (K2, K1 / K1ᵀ,
    K4 + K3 plain versions), the grid a tensor as a CUDA graph reads it,
    4 attempts a solve (the forward needs 3, every interval at most 2):
    the fixture's adjoint half, and the host-loop adjoint's stats, loss and
    gradients exactly."""
    f = dict(np.load(os.path.join(FIX, "ndcn_grads_grid400.npz")))
    tree = {n: {"w": f[f"{n}_w"].T, "b": f[f"{n}_b"]} for n in LAYERS}
    lap = operators.normalized_laplacian(generators.build_network("grid",
                                                                  400))
    op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                     sparse=fmt != "dense", format=fmt)
    runs = []
    for scan in (True, False):
        model = params_from_jax(tree)
        grid = torch.as_tensor(f["t"]) if scan else f["t"]
        out, stats = ndcn_forward(model, op, grid, torch.as_tensor(f["x0"]),
                                  max_steps=4, fused=fused, adjoint=True,
                                  scan=scan, rtol=0.01, atol=0.001,
                                  method="dopri5")
        loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
        loss.backward()
        runs.append((loss.detach(), stats, _grads(model), model))
    (loss, stats, grads, model), (h_loss, h_stats, h_grads, _) = runs
    assert isinstance(stats.nfe, torch.Tensor) and stats.host_syncs == 0
    assert _stats(stats) == _stats(h_stats) == (20, 3, 0, True)
    assert len(stats.backward) == len(f["t"]) - 1
    assert [_stats(b) for b in stats.backward] == \
        [_stats(b) for b in h_stats.backward]
    assert torch.equal(loss, h_loss)
    assert all(torch.equal(g, h) for g, h in zip(grads, h_grads))
    ref = float(f["loss_adjoint"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name in LAYERS:
        layer = getattr(model, name)
        assert rel_l1(layer.weight.grad, f[f"g_{name}_w_adjoint"]) < 1e-3
        assert rel_l1(layer.bias.grad, f[f"g_{name}_b_adjoint"]) < 1e-3


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "adams"])
def test_bounded_adjoint_matches_the_jax_package(method):
    """``ndcn_forward(adjoint=True, scan=True)`` against the JAX package's
    ``odeint_adjoint`` (its forward and every interval a
    ``lax.while_loop``) on the same weights and inputs (a 36-node grid,
    5 intervals)."""
    lap = operators.normalized_laplacian(generators.build_network("grid", 36))
    j_params = j_init_ndcn(jax.random.PRNGKey(3), 1, 8, 1)
    x0 = np.random.RandomState(1).uniform(0.0, 5.0, (36, 1)).astype(
        np.float32)
    t = np.linspace(0.0, 1.5, 6).astype(np.float32)
    target = np.random.RandomState(2).rand(6, 36, 1).astype(np.float32)
    kw = dict(rtol=0.01, atol=0.001, method=method, adjoint=True,
              max_steps=24)

    def j_loss(p):
        out, _ = j_ndcn_forward(p, j_as_operator(lap), jnp.asarray(t),
                                jnp.asarray(x0), **kw)
        return jnp.mean(jnp.abs(out - target))

    j_val, j_grads = jax.value_and_grad(j_loss)(j_params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    out, stats = ndcn_forward(model, as_operator(lap), torch.as_tensor(t),
                              torch.as_tensor(x0), scan=True, **kw)
    loss = (out - torch.as_tensor(target)).abs().mean()
    loss.backward()
    assert bool(stats.success)
    assert all(bool(b.success) for b in stats.backward)
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    for n in LAYERS:
        assert rel_l1(getattr(model, n).weight.grad.numpy().T,
                      j_grads[n]["w"]) < 1e-3, n
        assert rel_l1(getattr(model, n).bias.grad, j_grads[n]["b"]) < 1e-3


def test_bounded_adjoint_starved_interval_is_nan():
    """A budget the forward fits (36 of 37 attempts) but the backward's
    interval does not (it needs 38): that interval's solve fails, loudly,
    as in the host-loop adjoint: its stats say so and the gradients are
    NaN."""
    a = torch.tensor([[-0.5, 2.0, 0.0], [-2.0, -0.3, 0.2], [0.0, 0.3, -0.4]])
    out = []
    for scan in (True, False):
        k = torch.tensor(1.0, requires_grad=True)
        sol, st = odeint_adjoint_with_stats(
            lambda tt, y: k * (a @ y) + k * torch.sin(y), torch.ones(3),
            torch.tensor([0.0, 3.0]), (k,), rtol=1e-6, atol=1e-8,
            method="dopri5", options={"max_steps": 37, "scan": scan})
        sol.sum().backward()
        out.append((st, k.grad))
    (st, g), (h_st, h_g) = out
    assert _stats(st) == _stats(h_st) and bool(st.success)
    assert [_stats(b) for b in st.backward] == \
        [_stats(b) for b in h_st.backward]
    assert not bool(st.backward[0].success)
    assert torch.isnan(g) and torch.isnan(h_g)
