"""Replica sweeps on the CPU (``parallel.sweep``, ``ode.adaptive
.solve_batched``, the stacked NDCN) against ``jax.vmap`` of the JAX
package's solve and train step, and against the port's own one-replica
solves and steps; inputs from numpy seeds, weights carried across by
``convert`` (a JAX tree with a leading replica axis, from
``jax.vmap(init_ndcn)``, loads into a stacked model).

Bars: a batched solve within 1e-5 rel-L1 of ``jax.vmap`` of the JAX solve
with equal accepted / rejected counts per replica, and within 1e-6 of the
port's one-replica solves with equal stats; one replica-sweep train step
within 1e-4 (losses) and 1e-3 rel-L1 (updated parameters) of
``jax.vmap(sgd_step)``; a starved replica leaves the others' parameters
and Adam states bit-equal; stacked Adam bit-equal to one Adam a replica.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.train.losses import l1_loss as j_l1_loss
from ndcn_tpu.train.optim import make_sgd_step as j_make_sgd_step
from ndcn_tpu.train.optim import torch_adam as j_torch_adam
from ndcn_tpu_torch.convert import params_from_jax, params_to_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.ode import BatchedSolveStats, nan_unless
from ndcn_tpu_torch.parallel.sweep import (batched_init, replica_generators,
                                           replica_l1, stack_models,
                                           unstack_model)
from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam

R, HIDDEN = 3, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one thread beats a pool that shares the
    cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def grid36():
    lap = operators.normalized_laplacian(generators.build_network("grid", 36))
    x0 = generators.grid_block_initial_value(6)[:36].astype(np.float32)
    t = np.linspace(0.0, 3.0, 12).astype(np.float32)
    target = np.random.RandomState(1).rand(12, 36, 1).astype(np.float32)
    return lap.astype(np.float32), x0, t, target


def rel_l1(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _jax_replicas(seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    return jax.vmap(lambda k: j_init_ndcn(k, 1, HIDDEN, 1))(keys)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("method,rtol", [("dopri5", 1e-4), ("rk4", 1e-3)])
def test_batched_solve_matches_vmapped_jax_solve(grid36, method, rtol):
    """The stacked NDCN's batched inference solve against ``jax.vmap`` of
    the JAX forward on the same stacked weights: trajectories within 1e-5
    rel-L1, accepted and rejected attempts equal replica by replica."""
    lap, x0, t, _ = grid36
    j_params = _jax_replicas()
    kw = dict(rtol=rtol, atol=rtol / 10, method=method, max_steps=256,
              nondiff=True)
    j_out, j_stats = jax.vmap(lambda p: j_ndcn_forward(
        p, j_as_operator(lap), jnp.asarray(t), jnp.asarray(x0), **kw))(
        j_params)
    model = params_from_jax(_to_np(j_params))
    out, stats = ndcn_forward(model, as_operator(lap), t, torch.as_tensor(x0),
                              **kw)
    assert isinstance(stats, BatchedSolveStats) and all(stats.success)
    assert out.shape == (len(t), R, 36, 1)
    assert rel_l1(out.numpy().transpose(1, 0, 2, 3), j_out) <= 1e-5
    assert list(stats.n_accepted) == np.asarray(j_stats.n_accepted).tolist()
    assert list(stats.n_rejected) == np.asarray(j_stats.n_rejected).tolist()


@pytest.mark.parametrize("method,rtol", [
    ("dopri5", 1e-3), ("dopri5", 1e-6), ("tsit5", 1e-5), ("rk4", 1e-3),
    ("euler", 1e-3), ("midpoint", 1e-3)])
def test_batched_solve_matches_solo_solves(grid36, method, rtol):
    """The batched solve, differentiable and not, against three one-replica
    solves of the port: per replica the same stats and trajectories within
    1e-6 (the tight tolerance takes rejected attempts)."""
    lap, x0, t, _ = grid36
    gens = replica_generators(0, R)
    model = batched_init(lambda g: init_ndcn(g, 1, HIDDEN, 1), gens)
    op = as_operator(lap)
    kw = dict(rtol=rtol, atol=rtol / 10, method=method, max_steps=512)
    for nondiff in (True, False):
        out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                                  nondiff=nondiff, **kw)
        for i in range(R):
            one, st = ndcn_forward(unstack_model(model, i), op, t,
                                   torch.as_tensor(x0), nondiff=nondiff, **kw)
            assert stats.replica(i)[:4] == st[:4]
            assert rel_l1(out[:, i].detach(), one.detach()) <= 1e-6
    if rtol == 1e-6:
        assert min(stats.n_rejected) > 0


def _jax_step(j_op, t, x0, target, fused, max_steps):
    """``jax.vmap`` of the JAX dynamics driver's sgd_step (its train_loss:
    the L1 of the trajectory, NaN where the solve failed)."""
    opt = j_torch_adam(0.01, 1e-3)

    def train_loss(p, rng):
        out, stats = j_ndcn_forward(p, j_op, jnp.asarray(t), jnp.asarray(x0),
                                    rtol=0.01, atol=0.001, method="dopri5",
                                    max_steps=max_steps, fused=fused)
        loss = j_l1_loss(out, jnp.asarray(target))
        loss = jnp.where(stats.success, loss, jnp.nan)
        return loss, loss

    step = j_make_sgd_step(opt, train_loss)
    return opt, jax.vmap(step)


@pytest.mark.parametrize("fmt,fused", [("dense", False), ("dense", True),
                                       ("coo", False), ("bsr", False)])
def test_replica_train_step_matches_vmapped_jax_step(grid36, fmt, fused):
    """One step of the replica sweep (the heat driver's ``--replicas 3``
    step: the sum of the replicas' L1 losses, one Adam) against
    ``jax.vmap(sgd_step)`` on the converted stacked weights: losses within
    1e-4, updated parameters within 1e-3 rel-L1. Dense ``fused`` is K2,
    in Pallas interpret mode on the JAX side; BSR is K3 likewise."""
    lap, x0, t, target = grid36
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    j_op = j_as_operator(mat, sparse=fmt != "dense", format=fmt)
    j_params = _jax_replicas(3)
    opt, vstep = _jax_step(j_op, t, x0, target, fused, 32)
    j_p, _, j_losses, _ = vstep(j_params, jax.vmap(opt.init)(j_params),
                                jax.random.split(jax.random.PRNGKey(0), R))
    model = params_from_jax(_to_np(j_params))
    op = as_operator(mat, sparse=fmt != "dense", format=fmt)
    port_opt = torch_adam(model.parameters(), 0.01, 1e-3)
    x0_t, target_t = torch.as_tensor(x0), torch.as_tensor(target)

    def losses():
        out, stats = ndcn_forward(model, op, t, x0_t, max_steps=32,
                                  fused=fused, rtol=0.01, atol=0.001)
        ls = nan_unless(stats.success,
                        replica_l1(out.transpose(0, 1), target_t))
        return ls, ls

    got, _ = make_replica_sgd_step(port_opt, losses)()
    assert float(np.abs(got.numpy() - np.asarray(j_losses)).max()) <= 1e-4
    tree = params_to_jax(model)
    for name in tree:
        for leaf in tree[name]:
            assert rel_l1(tree[name][leaf], j_p[name][leaf]) <= 1e-3, (name,
                                                                       leaf)


def test_starved_replica_reads_nan_and_leaves_the_others_bit_equal(grid36):
    """Replica seed 1 needs 13 attempts; a budget of 10 starves it: its
    loss reads NaN, its gradient is zero (its parameters stay finite, as
    under ``jax.vmap``), and the other replicas' parameters and Adam states
    are bit-equal to a sweep without it, and to one with a healthy replica
    in its place, over two steps."""
    lap, x0, _, target = grid36
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    target = torch.as_tensor(target[:10])
    op = as_operator(lap)
    kw = dict(rtol=1e-4, atol=1e-5, max_steps=10)
    need = [ndcn_forward(init_ndcn(torch.Generator().manual_seed(s), 1,
                                   HIDDEN, 1), op, t, torch.as_tensor(x0),
                         nondiff=True, **dict(kw, max_steps=1000))[1]
            for s in (0, 1, 2, 4)]
    assert [s.n_accepted + s.n_rejected for s in need] == [7, 13, 7, 5]

    def sweep(seeds):
        model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1,
                                        HIDDEN, 1) for s in seeds])
        opt = torch_adam(model.parameters(), 0.01, 1e-3)

        def losses():
            out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                                      **kw)
            ls = nan_unless(stats.success,
                            replica_l1(out.transpose(0, 1), target))
            return ls, ls

        step = make_replica_sgd_step(opt, losses)
        return model, opt, [step()[0] for _ in range(2)]

    starved, opt_s, loss_s = sweep([0, 1, 2])
    without, opt_w, _ = sweep([0, 2])
    healthy, opt_h, _ = sweep([0, 4, 2])
    assert bool(torch.isnan(loss_s[0][1])) and not torch.isnan(
        loss_s[0][[0, 2]]).any()
    assert all(bool(torch.isfinite(p).all())
               for p in unstack_model(starved, 1).parameters())

    def state(model, opt, i):
        params = [p.detach()[i] for p in model.parameters()]
        moments = [opt.state[p][k][i] for p in model.parameters()
                   for k in ("exp_avg", "exp_avg_sq")]
        return params + moments

    for i, j in ((0, 0), (2, 1)):
        for a, b in zip(state(starved, opt_s, i), state(without, opt_w, j)):
            assert torch.equal(a, b)
        for a, b in zip(state(starved, opt_s, i), state(healthy, opt_h, i)):
            assert torch.equal(a, b)


def test_stacked_adam_is_elementwise():
    """Adam over stacked parameters (one step count, coupled weight decay,
    bias correction) is bit-equal to one Adam a replica, step by step."""
    rng = np.random.RandomState(0)
    init = rng.randn(R, 5, 4).astype(np.float32)
    grads = rng.randn(6, R, 5, 4).astype(np.float32)
    stacked = torch.nn.Parameter(torch.as_tensor(init))
    opt = torch_adam([stacked], 0.05, 0.01)
    solos = [torch.nn.Parameter(torch.as_tensor(init[i])) for i in range(R)]
    opts = [torch_adam([p], 0.05, 0.01) for p in solos]
    for g in grads:
        stacked.grad = torch.as_tensor(g)
        opt.step()
        for i, (p, o) in enumerate(zip(solos, opts)):
            p.grad = torch.as_tensor(g[i])
            o.step()
            assert torch.equal(stacked.detach()[i], p.detach())


def test_stacked_weights_cross_from_a_vmapped_jax_init():
    """``jax.vmap(init_ndcn)(keys)`` loads into a stacked model whose
    replica i is that replica's tree loaded alone, and exports back."""
    j_params = _to_np(_jax_replicas(5))
    model = params_from_jax(j_params)
    assert model.replicas == R and model.dec.weight.shape == (R, 1, HIDDEN)
    for i in range(R):
        one = params_from_jax(jax.tree_util.tree_map(lambda a: a[i],
                                                     j_params))
        for p, q in zip(unstack_model(model, i).parameters(),
                        one.parameters()):
            assert torch.equal(p, q)
    back = params_to_jax(model)
    for name in j_params:
        for leaf in j_params[name]:
            assert np.array_equal(back[name][leaf], j_params[name][leaf])
