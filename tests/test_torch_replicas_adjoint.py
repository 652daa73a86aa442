"""The continuous adjoint under replicas on the CPU (``ode.adjoint`` with
``batched``: the batched forward solve, the backward's batched augmented
state (y, adj_y, adj_t, *adj_params) with per-replica norms), against
``jax.vmap`` of the JAX package's adjoint step and against the port's
one-replica adjoints. Inputs from numpy seeds; weights carried across by
``convert`` from ``jax.vmap(init_ndcn)``; the COO and BSR operators run
the kernels' plain batched versions (K1 over Aᵀ, K3 over Aᵀ in the VJPs).

Bars: losses within 1e-4 and every gradient within 1e-3 rel-L1 of
``jax.vmap(jax.value_and_grad(loss))`` with ``adjoint=True``, for dopri5
and adams on dense, COO and BSR; each replica's gradients within 1e-5
rel-L1 of its own adjoint, with equal forward and backward stats; a
starved replica reads NaN and leaves the others' gradients bit-equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu_torch.convert import params_from_jax, params_to_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.ode import nan_unless
from ndcn_tpu_torch.ode.adjoint import AdjointStats
from ndcn_tpu_torch.parallel.sweep import (batched_init,
                                           make_ndcn_replica_train_step,
                                           replica_generators, stack_models,
                                           unstack_model)

R, HIDDEN = 3, 8
KW = dict(rtol=0.01, atol=0.001, max_steps=64)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid36():
    lap = operators.normalized_laplacian(generators.build_network("grid", 36))
    x0 = generators.grid_block_initial_value(6)[:36].astype(np.float32)
    t = np.linspace(0.0, 3.0, 8).astype(np.float32)
    target = np.random.RandomState(1).rand(8, 36, 1).astype(np.float32)
    return lap.astype(np.float32), x0, t, target


def rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _grad_tree(model):
    """The gradients of a model, as the JAX package's parameter tree."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return params_to_jax(g)


def _losses(model, op, t, x0, target, method):
    """Each replica's L1 loss (R,), NaN where its solve failed; one model's
    loss (0-dim)."""
    out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                              method=method, adjoint=True, **KW)
    if out.ndim == 3:                                   # one model
        return (out - torch.as_tensor(target)).abs().mean(), stats
    diff = (out - torch.as_tensor(target).unsqueeze(1)).abs()
    return nan_unless(stats.success, diff.mean(dim=(0, 2, 3))), stats


@pytest.mark.parametrize("fmt", ["dense", "coo", "bsr"])
@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_batched_adjoint_matches_vmapped_jax_adjoint(grid36, fmt, method):
    lap, x0, t, target = grid36
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    j_op = j_as_operator(mat, sparse=fmt != "dense", format=fmt)
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    j_params = jax.vmap(lambda k: j_init_ndcn(k, 1, HIDDEN, 1))(keys)

    def j_loss(p):
        out, _ = j_ndcn_forward(p, j_op, jnp.asarray(t), jnp.asarray(x0),
                                method=method, adjoint=True, **KW)
        return jnp.mean(jnp.abs(out - jnp.asarray(target)))

    j_l, j_g = jax.vmap(jax.value_and_grad(j_loss))(j_params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    op = as_operator(mat, sparse=fmt != "dense", format=fmt)
    losses, stats = _losses(model, op, t, x0, target, method)
    losses.sum().backward()
    assert isinstance(stats, AdjointStats) and all(stats.success)
    assert len(stats.backward) == len(t) - 1
    assert float(np.abs(losses.detach().numpy() - np.asarray(j_l)).max()) \
        <= 1e-4
    got = _grad_tree(model)
    for name in got:
        for leaf in got[name]:
            assert rel_l1(got[name][leaf], j_g[name][leaf]) <= 1e-3, (name,
                                                                      leaf)


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_batched_adjoint_matches_solo_adjoints(grid36, method):
    """Each replica's gradients against its own adjoint (1e-5 rel-L1),
    with its forward and backward stats equal; the ablation that drops the
    control layer gets zero cotangents there, per replica."""
    lap, x0, t, target = grid36
    op = as_operator(lap)
    model = batched_init(lambda g: init_ndcn(g, 1, HIDDEN, 1),
                         replica_generators(0, R))
    losses, stats = _losses(model, op, t, x0, target, method)
    losses.sum().backward()
    for i in range(R):
        one = unstack_model(model, i)
        loss_i, st = _losses(one, op, t, x0, target, method)
        loss_i.backward()
        mine = stats.replica(i)
        assert mine[:4] == st[:4]
        assert [b[:4] for b in mine.backward] == [b[:4] for b in st.backward]
        for (name, p), q in zip(model.named_parameters(), one.parameters()):
            assert rel_l1(p.grad[i], q.grad) <= 1e-5, name
    # no_control: the RHS reads no parameter, the VJPs ask for none
    out, _ = ndcn_forward(model, op, t, torch.as_tensor(x0), method=method,
                          adjoint=True, no_control=True, **KW)
    model.zero_grad()
    out.abs().sum().backward()
    assert all(bool(torch.isfinite(p.grad).all())
               for n, p in model.named_parameters() if p.grad is not None)


def test_starved_adjoint_replica_reads_nan_and_leaves_the_others_bit_equal(
        grid36):
    """A budget that the healthy replicas meet forward and backward and a
    stiffer replica (its control weight scaled up) does not meet forward:
    its loss reads NaN, and the other replicas' gradients are bit-equal to
    a sweep without it."""
    lap, x0, _, target = grid36
    t = np.linspace(0.0, 5.0, 8).astype(np.float32)
    op = as_operator(lap)
    kw = dict(rtol=1e-4, atol=1e-5, method="dopri5")

    def model_of(seed):
        model = init_ndcn(torch.Generator().manual_seed(seed), 1, HIDDEN, 1)
        if seed == 1:
            with torch.no_grad():
                model.wt.weight.mul_(6.0)
        return model

    def attempts(stats):
        return stats.n_accepted + stats.n_rejected

    need = []
    for seed in range(3):
        out, stats = ndcn_forward(model_of(seed), op, t, torch.as_tensor(x0),
                                  adjoint=True, max_steps=1000, **kw)
        out.sum().backward()
        need.append((attempts(stats),
                     max(attempts(b) for b in stats.backward)))
    # a solve that spent its attempts stops before it reads the dense
    # output of its last one: one attempt more than it took
    budget = max(max(need[0]), max(need[2])) + 1
    assert need[1][0] >= budget

    def grads(seeds):
        model = stack_models([model_of(s) for s in seeds])
        out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                                  adjoint=True, max_steps=budget, **kw)
        losses = nan_unless(stats.success, (out - torch.as_tensor(
            target).unsqueeze(1)).abs().mean(dim=(0, 2, 3)))
        losses.sum().backward()
        return losses.detach(), model

    loss_s, model_s = grads([0, 1, 2])
    _, model_w = grads([0, 2])
    assert bool(torch.isnan(loss_s[1]))
    assert not torch.isnan(loss_s[[0, 2]]).any()
    for j, i in enumerate((0, 2)):
        for p, q in zip(model_s.parameters(), model_w.parameters()):
            assert bool(torch.isfinite(q.grad[j]).all())
            assert torch.equal(p.grad[i], q.grad[j])


def test_replica_train_step_takes_the_adjoint(grid36):
    """``make_ndcn_replica_train_step(adjoint=True)``: its losses are the
    backprop step's forward, and its update is one Adam step from the
    batched adjoint's gradients, bit for bit."""
    from ndcn_tpu_torch.parallel.sweep import replica_l1
    from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam

    lap, x0, t, target = grid36
    op = as_operator(lap)
    x0_t, target_t = torch.as_tensor(x0), torch.as_tensor(target)
    out = {}
    for adjoint in (False, True):
        init_fn, step_fn = make_ndcn_replica_train_step(
            op, t, x0_t, target_t, hidden=HIDDEN, adjoint=adjoint)
        model, opt = init_fn(replica_generators(0, R))
        out[adjoint] = (step_fn(model, opt), model)
    assert float((out[True][0] - out[False][0]).abs().max()) <= 1e-6
    by_hand = batched_init(lambda g: init_ndcn(g, 1, HIDDEN, 1),
                           replica_generators(0, R))
    opt = torch_adam(by_hand.parameters(), 0.01, 1e-3)

    def losses():
        pred, stats = ndcn_forward(by_hand, op, t, x0_t, max_steps=64,
                                   adjoint=True)
        ls = nan_unless(stats.success, replica_l1(pred.transpose(0, 1),
                                                  target_t))
        return ls, ls

    make_replica_sgd_step(opt, losses)()
    for p, q in zip(out[True][1].parameters(), by_hand.parameters()):
        assert torch.equal(p.detach(), q.detach())
