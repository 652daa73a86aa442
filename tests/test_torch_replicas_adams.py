"""The Adams family under replicas on the CPU: the stacked NDCN's batched
adams (``ode.vcabm.solve_vcabm_batched``, the masked VCABM machine with a
replica axis), fixed_adams and explicit_adams against ``jax.vmap`` of the
JAX package's solve and train step, and against the port's one-replica
solves. Inputs from numpy seeds; weights carried across by ``convert``
from ``jax.vmap(init_ndcn)``.

Bars: a batched inference solve within 1e-5 rel-L1 of ``jax.vmap`` of the
JAX solve, NFE per replica within 2 %; batched adams within 1e-5 rel-L1 of
each replica's ``solve_vcabm`` alone, and with equal step counts on a
float64 state (the masked sums round differently from the host-indexed
ones only in float32's last bits); one replica-sweep train step within
1e-4 (losses) and 1e-3 rel-L1 (updated parameters) of ``jax.vmap(sgd_step)``;
a starved replica reads NaN and leaves the others bit-equal. The first
step of the heat driver's ``--replicas 4`` adams sweep (grid400, backprop
through the controller) moves with float32's rounding: the port's float32
gradients no farther from its float64 ones than the JAX package's from
theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.train.losses import l1_loss as j_l1_loss
from ndcn_tpu.train.optim import make_sgd_step as j_make_sgd_step
from ndcn_tpu.train.optim import torch_adam as j_torch_adam
from ndcn_tpu_torch.convert import params_from_jax, params_to_jax
from ndcn_tpu_torch.experiments.dynamics import heat_ground_truth
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_dense
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.ode import BatchedSolveStats, nan_unless, vcabm
from ndcn_tpu_torch.parallel.sweep import (batched_init, replica_generators,
                                           replica_l1, stack_models,
                                           unstack_model)
from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam
from ndcn_tpu_torch.train.sampling import sample_times

R, HIDDEN = 3, 8
ADAMS = ("adams", "fixed_adams", "explicit_adams")


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


@pytest.mark.parametrize("method", ADAMS)
def test_batched_adams_matches_vmapped_jax_solve(grid36, method):
    lap, x0, t, _ = grid36
    j_params = _jax_replicas()
    kw = dict(rtol=0.01, atol=0.001, method=method, max_steps=256,
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
    for mine, theirs in zip(stats.nfe, np.asarray(j_stats.nfe).tolist()):
        assert abs(mine - theirs) <= 0.02 * theirs


@pytest.mark.parametrize("rtol", [1e-2, 1e-5])
def test_batched_adams_matches_solo_solves(grid36, rtol):
    """Differentiable and not, each replica within 1e-5 rel-L1 of its own
    ``solve_vcabm`` (the tight tolerance takes rejected attempts and
    higher orders)."""
    lap, x0, t, _ = grid36
    model = batched_init(lambda g: init_ndcn(g, 1, HIDDEN, 1),
                         replica_generators(0, R))
    op = as_operator(lap)
    kw = dict(rtol=rtol, atol=rtol / 10, method="adams", max_steps=512)
    for nondiff in (True, False):
        out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                                  nondiff=nondiff, **kw)
        for i in range(R):
            one, st = ndcn_forward(unstack_model(model, i), op, t,
                                   torch.as_tensor(x0), nondiff=nondiff, **kw)
            assert st.success and stats.success[i]
            assert rel_l1(out[:, i].detach(), one.detach()) <= 1e-5


def test_batched_adams_steps_equal_solo_steps_on_float64():
    """On a float64 state (and float64 time) the masked machine takes each
    replica's own steps: equal NFE and accepted / rejected counts, and
    observations equal to the host-indexed solve's to 1e-12."""
    rs = np.random.RandomState(0)
    a = torch.as_tensor(rs.randn(30, 30) * 0.3 - np.eye(30))
    w = torch.as_tensor(rs.randn(R, 4, 4) * 0.5)
    y0 = torch.as_tensor(rs.randn(R, 30, 4))
    t = torch.linspace(0.0, 3.0, 12, dtype=torch.float64)

    def func(tt, y):
        return torch.tanh(torch.einsum("ij,rjk->rik", a, y) @ w)

    out, stats = vcabm.solve_vcabm_batched(func, y0, t, 1e-5, 1e-6)
    for i in range(R):
        one, st = vcabm.solve_vcabm(
            lambda tt, y, i=i: torch.tanh(a @ y @ w[i]), y0[i], t, 1e-5,
            1e-6)
        assert stats.replica(i)[:4] == st[:4]
        assert stats.n_accepted[i] > 20
        assert float((out[:, i] - one).abs().max()) <= 1e-12


def _jax_step(j_op, t, x0, target, method, max_steps):
    opt = j_torch_adam(0.01, 1e-3)

    def train_loss(p, rng):
        out, stats = j_ndcn_forward(p, j_op, jnp.asarray(t), jnp.asarray(x0),
                                    rtol=0.01, atol=0.001, method=method,
                                    max_steps=max_steps)
        loss = j_l1_loss(out, jnp.asarray(target))
        loss = jnp.where(stats.success, loss, jnp.nan)
        return loss, loss

    return opt, jax.vmap(j_make_sgd_step(opt, train_loss))


@pytest.mark.parametrize("method", ADAMS)
def test_replica_train_step_matches_vmapped_jax_step(grid36, method):
    """One step of the replica sweep with an Adams method (backprop through
    the batched solve; for adams through its step-size and order
    controller, as JAX's ``solve_vcabm_scan`` under ``jax.vmap``)."""
    lap, x0, t, target = grid36
    j_params = _jax_replicas(3)
    opt, vstep = _jax_step(j_as_operator(lap), t, x0, target, method, 64)
    j_p, _, j_losses, _ = vstep(j_params, jax.vmap(opt.init)(j_params),
                                jax.random.split(jax.random.PRNGKey(0), R))
    model = params_from_jax(_to_np(j_params))
    op = as_operator(lap)
    port_opt = torch_adam(model.parameters(), 0.01, 1e-3)
    x0_t, target_t = torch.as_tensor(x0), torch.as_tensor(target)

    def losses():
        out, stats = ndcn_forward(model, op, t, x0_t, max_steps=64,
                                  method=method, rtol=0.01, atol=0.001)
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


def test_starved_adams_replica_reads_nan_and_leaves_the_others_bit_equal(
        grid36):
    """A budget one replica cannot meet: its loss reads NaN, its gradient
    is zero, and the other replicas' parameters and Adam states are
    bit-equal to a sweep without it, over two steps."""
    lap, x0, _, target = grid36
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    target = torch.as_tensor(target[:10])
    op = as_operator(lap)
    kw = dict(rtol=1e-4, atol=1e-5, method="adams")
    need = [ndcn_forward(init_ndcn(torch.Generator().manual_seed(s), 1,
                                   HIDDEN, 1), op, t, torch.as_tensor(x0),
                         nondiff=True, max_steps=1000, **kw)[1]
            for s in range(3)]
    attempts = [s.n_accepted + s.n_rejected for s in need]
    starved = int(np.argmax(attempts))
    budget = sorted(attempts)[-2]
    assert budget < attempts[starved]

    def sweep(seeds):
        model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1,
                                        HIDDEN, 1) for s in seeds])
        opt = torch_adam(model.parameters(), 0.01, 1e-3)

        def losses():
            out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                                      max_steps=budget, **kw)
            ls = nan_unless(stats.success,
                            replica_l1(out.transpose(0, 1), target))
            return ls, ls

        step = make_replica_sgd_step(opt, losses)
        return model, opt, [step()[0] for _ in range(2)]

    model_s, opt_s, loss_s = sweep([0, 1, 2])
    others = [i for i in range(3) if i != starved]
    model_w, opt_w, _ = sweep(others)
    assert bool(torch.isnan(loss_s[0][starved]))
    assert not torch.isnan(loss_s[0][others]).any()
    assert all(bool(torch.isfinite(p).all())
               for p in unstack_model(model_s, starved).parameters())

    def state(model, opt, i):
        params = [p.detach()[i] for p in model.parameters()]
        moments = [opt.state[p][k][i] for p in model.parameters()
                   for k in ("exp_avg", "exp_avg_sq")]
        return params + moments

    for j, i in enumerate(others):
        for a, b in zip(state(model_s, opt_s, i), state(model_w, opt_w, j)):
            assert torch.equal(a, b)


def test_adams_backprop_gradients_move_with_float32_as_jax_s_do():
    """The first step of ``heat --replicas 4 --method adams`` (grid400, T 5,
    tick 100, irregular, seed 0; the replicas seeded 0-3): backprop through
    adams's step-size and order controller. Its float32 gradients part from
    its float64 ones by some 1e-3 rel-L1 (the controller's choices move
    with the rounding), in the JAX package as in the port: the port's
    float32 gradients are no farther from its float64 ones (float64 time
    too) than the JAX package's from theirs (4.4e-3 against 9.0e-3)."""
    adj = generators.build_network("grid", 400)
    lap = operators.normalized_laplacian(adj)
    hs = sample_times(5.0, 100, "irregular", seed=0)
    x0 = torch.as_tensor(generators.grid_block_initial_value(20)
                         .astype(np.float32))
    sol, _ = heat_ground_truth(as_operator(operators.laplacian_dense(adj)),
                               x0, hs.t)
    target, t = sol[hs.id_train], hs.t[hs.id_train]

    def port_grads(dtype):
        """The port's gradients as the JAX package's parameter tree."""
        model = stack_models([init_ndcn(torch.Generator().manual_seed(s), 1,
                                        20, 1) for s in range(4)]).to(dtype)
        op = (from_dense(lap, dtype=dtype) if dtype == torch.float64
              else as_operator(lap))
        vt = np.asarray(t, np.float64 if dtype == torch.float64
                        else np.float32)
        out, stats = ndcn_forward(model, op, vt, x0.to(dtype), method="adams",
                                  max_steps=256, rtol=0.01, atol=0.001)
        nan_unless(stats.success, replica_l1(
            out.transpose(0, 1), target.to(dtype))).sum().backward()
        weights = params_to_jax(model)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(p.grad)
        return weights, params_to_jax(model)

    def jax_grads(tree, dtype):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)

        def loss(p):
            out, _ = j_ndcn_forward(
                p, j_as_operator(np.asarray(lap, dtype)),
                jnp.asarray(np.asarray(t, dtype)),
                jnp.asarray(x0.numpy(), dtype), rtol=0.01, atol=0.001,
                method="adams", max_steps=256)
            return j_l1_loss(out, jnp.asarray(target.numpy(), dtype))

        return _to_np(jax.jit(jax.vmap(jax.grad(loss)))(params))

    weights, port32 = port_grads(torch.float32)
    _, port64 = port_grads(torch.float64)
    jax32 = jax_grads(weights, np.float32)
    with jax.enable_x64(True):
        jax64 = jax_grads(weights, np.float64)

    def dist(a, b):
        return max(rel_l1(a[k][leaf], b[k][leaf]) for k in a for leaf in a[k])

    port_dist, jax_dist = dist(port32, port64), dist(jax32, jax64)
    assert 1e-3 < port_dist <= jax_dist, (port_dist, jax_dist)
