"""The training slice end to end on the CPU: the differentiable solve, the
kernels' backward (plain versions), the optimizer, the operators and the heat
experiment, against the JAX package and the torchdiffeq-oracle fixture.

Weights cross through ``convert.params_from_jax``; inputs come from numpy
seeds. Bars:
- ``ndcn_grads_grid400`` (the reference's ``loss.backward()``): loss within
  1e-4 relative, every gradient within 1e-3 rel-L1, the JAX package's own
  bars (``tests/test_gradients.py``), for every operator format and
  ``fused`` setting;
- ``jax.grad`` of the JAX package's ``ndcn_forward``: 1e-4 rel-L1 (the same
  f32 program, sums in another order), with equal NFE;
- the grad guard: finite, and within 5e-2 of the clean solve's gradient, as
  ``tests/test_solvers.py``;
- torch-parity Adam: 1e-5 / 1e-6, as ``tests/test_optim_parity.py``;
- operators: bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph import operators as j_operators
from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.ode import odeint as j_odeint
from ndcn_tpu.train.optim import torch_adam as j_torch_adam
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.experiments.dynamics import build_parser, run
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, matvec
from ndcn_tpu_torch.kernels import fused_rhs
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.models.nn import dropout_mask
from ndcn_tpu_torch.ode import odeint_with_stats
from ndcn_tpu_torch.train.budget import probe_step_budget
from ndcn_tpu_torch.train.elastic import ElasticBudget
from ndcn_tpu_torch.train.losses import l1_loss, relative_l1
from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(rtol=0.01, atol=0.001, method="dopri5")
LAYERS = ("enc1", "enc2", "wt", "dec")


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _grad_fixture():
    f = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                  "ndcn_grads_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in LAYERS}
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    return f, tree, lap


@pytest.mark.parametrize("fmt,fused", [
    ("dense", False), ("dense", "auto"), ("dense", True), ("coo", False),
    ("bsr", False), ("bsr", True)])
def test_gradient_parity_vs_reference_fixture(fmt, fused):
    """The flagship l1 training loss and its gradients against the
    reference's backprop through torchdiffeq at fixed weights."""
    f, tree, lap = _grad_fixture()
    model = params_from_jax(tree)
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    op = as_operator(mat, sparse=fmt != "dense",
                     format="coo" if fmt == "dense" else fmt)
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              max_steps=64, fused=fused, **KW)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert stats.success
    ref = float(f["loss_backprop"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name in LAYERS:
        layer = getattr(model, name)
        assert rel_l1(layer.weight.grad, f[f"g_{name}_w_backprop"]) < 1e-3
        assert rel_l1(layer.bias.grad, f[f"g_{name}_b_backprop"]) < 1e-3


def _grads_vs_jax(j_params, j_op, op, t, x0, fused=False, max_steps=32):
    """Loss and gradients of the port and of the JAX package on one input;
    returns the worst rel-L1 over the gradients, and both NFE."""
    target = np.random.RandomState(7).rand(len(t), x0.shape[0]) \
        .astype(np.float32)

    def j_loss(p):
        out, stats = j_ndcn_forward(p, j_op, jnp.asarray(t), jnp.asarray(x0),
                                    max_steps=max_steps, fused=fused, **KW)
        return jnp.mean(jnp.abs(out[..., 0] - target)), stats

    (j_val, j_stats), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        j_params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    out, stats = ndcn_forward(model, op, t, torch.as_tensor(x0),
                              max_steps=max_steps, fused=fused, **KW)
    loss = (out[..., 0] - torch.as_tensor(target)).abs().mean()
    loss.backward()
    assert stats.success and bool(j_stats.success)
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    worst = max(max(rel_l1(getattr(model, n).weight.grad.numpy().T,
                           j_grads[n]["w"]),
                    rel_l1(getattr(model, n).bias.grad, j_grads[n]["b"]))
                for n in LAYERS)
    return worst, stats.nfe, int(j_stats.nfe)


def test_gradients_match_jax_on_a_2k_coo_graph():
    lap = operators.normalized_laplacian_sparse(
        generators.build_sparse_graph(2000, 10, seed=0))
    t = np.linspace(0.0, 2.0, 12).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (2000, 1)) \
        .astype(np.float32)
    worst, nfe, j_nfe = _grads_vs_jax(
        j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1),
        j_as_operator(lap, sparse=True), as_operator(lap, sparse=True), t, x0)
    assert worst < 1e-4 and nfe == j_nfe


@pytest.mark.parametrize("fused", [False, True])
def test_gradients_match_jax_on_a_non_symmetric_bsr_operator(fused):
    """A transpose bug in K3's or K4's backward would show here, not on a
    symmetric Laplacian. The JAX side runs its Pallas kernels in interpret
    mode."""
    rng = np.random.RandomState(3)
    a = sp.random(300, 300, density=0.03, random_state=rng, format="csr")
    a = (a - sp.diags(np.asarray(a.sum(1)).ravel())).astype(np.float32)
    assert abs(a - a.T).max() > 0.1
    t = np.linspace(0.0, 1.0, 6).astype(np.float32)
    x0 = rng.uniform(0.0, 2.0, (300, 1)).astype(np.float32)
    worst, nfe, j_nfe = _grads_vs_jax(
        j_init_ndcn(jax.random.PRNGKey(1), 1, 20, 1),
        j_as_operator(a, sparse=True, format="bsr"),
        as_operator(a, sparse=True, format="bsr"), t, x0, fused=fused)
    assert worst < 1e-4 and nfe == j_nfe


def _fresh_grid400_grads(package, monkeypatch, scale=None,
                         detach_first_ratio=False, relu_inputs=None):
    """Gradients (one flat vector, layer by layer, w as (in, out) then b) of
    the l1 loss of one grid400 train step from freshly initialised weights,
    by the port or by the JAX package on the same weights. ``scale``
    multiplies RHS evaluation 2 (stage 2 of the first step, at t = dt/5, the
    only evaluation with 0.03 < t < 0.05). ``relu_inputs`` collects the
    port's relu inputs, one tensor an evaluation."""
    from ndcn_tpu.models import ndcn as j_ndcn_module
    from ndcn_tpu_torch.models import ndcn as ndcn_module
    from ndcn_tpu_torch.ode import adaptive

    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    t = np.linspace(0.0, 2.0, 10).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (400, 1)) \
        .astype(np.float32)
    target = np.random.RandomState(1).rand(10, 400, 1).astype(np.float32)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1)
    with monkeypatch.context() as patch:
        if package == "jax":
            j_plain = j_ndcn_module.ode_func

            def j_rhs(params, op, t_, h, **kw):
                y = j_plain(params, op, t_, h, **kw)
                return jnp.where((t_ > 0.03) & (t_ < 0.05),
                                 y * jnp.float32(scale), y)

            if scale is not None:
                patch.setattr(j_ndcn_module, "ode_func", j_rhs)
            tree = {n: {"w": jnp.asarray(getattr(model, n).weight.detach()
                                         .numpy().T),
                        "b": jnp.asarray(getattr(model, n).bias.detach()
                                         .numpy())} for n in LAYERS}

            def j_loss(params):
                out, stats = j_ndcn_forward(
                    params, j_as_operator(lap, sparse=False), jnp.asarray(t),
                    jnp.asarray(x0), **KW)
                return jnp.mean(jnp.abs(out - target)), stats

            (_, stats), g = jax.value_and_grad(j_loss, has_aux=True)(tree)
            assert int(stats.nfe) == 20
            return np.concatenate([np.asarray(g[n][leaf]).ravel()
                                   for n in LAYERS for leaf in ("w", "b")])
        plain, seen = ndcn_module.ode_func, [0]

        def rhs(mdl, op, t_, h, **kw):
            y = plain(mdl, op, t_, h, **kw)
            if relu_inputs is not None:
                relu_inputs.append((matvec(op, h) @ mdl.wt.weight.t()
                                    + mdl.wt.bias).detach())
            seen[0] += 1
            return y * scale if scale is not None and seen[0] == 3 else y

        patch.setattr(ndcn_module, "ode_func", rhs)
        if detach_first_ratio:
            step_size, attempts = adaptive.optimal_step_size, [0]

            def detached(last_step, ratio, ctrl):
                attempts[0] += 1
                return step_size(last_step, ratio.detach() if attempts[0] == 1
                                 else ratio, ctrl)

            patch.setattr(adaptive, "optimal_step_size", detached)
        out, stats = ndcn_forward(model, as_operator(lap, sparse=False), t,
                                  torch.as_tensor(x0), **KW)
        (out - torch.as_tensor(target)).abs().mean().backward()
    assert stats.success and stats.nfe == 20
    return np.concatenate([g.numpy().ravel() for n in LAYERS
                           for g in (getattr(model, n).weight.grad.t(),
                                     getattr(model, n).bias.grad)])


ULP_DOWN, ULP_UP = 1.0 - 1e-7, 1.0 + 1e-7   # one float32 step off 1


def test_fresh_weight_gradients_jump_at_a_relu_kink(monkeypatch):
    """From freshly initialised weights on grid400 the loss is evaluated
    beside a kink: one relu input of RHS evaluation 5 (stage 5 of the first
    step) is within 1e-7·max|z| of zero, and no other of the solve's 20
    evaluations is. Scaling evaluation 2 by one ulp moves that input across
    zero; the forward and the steps stay, and the gradients jump by 4.0e-3
    rel-L1, while the ulp the other way moves them by < 1e-5. The jump comes
    through the first step's error ratio (2.8e-9, where the growth factor's
    derivative 0.1·factor/ratio is large): with that ratio detached it is
    gone. So two right implementations of the RHS can differ by 4.0e-3 in
    these gradients, and a comparison here holds one to a side of the kink
    (``tests/test_torch_cuda.py::test_train_step_gradients_on_cuda_match_cpu``)."""
    zs = []
    base = _fresh_grid400_grads("port", monkeypatch, relu_inputs=zs)
    near = [int((z.abs() <= 1e-7 * z.abs().max()).sum()) for z in zs]
    assert near == [0] * 5 + [1] + [0] * 14
    flipped = []
    down = _fresh_grid400_grads("port", monkeypatch, ULP_DOWN,
                                relu_inputs=flipped)
    flips = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(zs, flipped)]
    assert flips == [0] * 5 + [1] + [0] * 14
    up = _fresh_grid400_grads("port", monkeypatch, ULP_UP)
    assert 3.9e-3 <= rel_l1(down, base) <= 4.1e-3
    assert rel_l1(up, base) <= 1e-5
    smooth = [_fresh_grid400_grads("port", monkeypatch, scale,
                                   detach_first_ratio=True)
              for scale in (None, ULP_DOWN)]
    assert rel_l1(smooth[1], smooth[0]) <= 1e-4


def test_fresh_weight_gradient_jump_is_the_jax_packages_too(monkeypatch):
    """The JAX package on the same weights has the same two one-sided
    gradients: its own lands on one side, an ulp on RHS evaluation 2 takes
    it to the other, 4.0e-3 away, and each side agrees with the port's to
    1e-4."""
    j_sides = [_fresh_grid400_grads("jax", monkeypatch, scale)
               for scale in (ULP_DOWN, None, ULP_UP)]
    gaps = sorted(rel_l1(j_sides[i], j_sides[1]) for i in (0, 2))
    assert gaps[0] <= 1e-5 and 3.9e-3 <= gaps[1] <= 4.1e-3
    sides = [_fresh_grid400_grads("port", monkeypatch, scale)
             for scale in (ULP_DOWN, None, ULP_UP)]
    for mine in sides:
        assert min(rel_l1(mine, theirs) for theirs in j_sides) <= 1e-4
    for theirs in j_sides:
        assert min(rel_l1(mine, theirs) for mine in sides) <= 1e-4


def test_grad_guard_survives_a_rejected_overflowing_step():
    """The twin of ``tests/test_solvers.py``'s overflow test: a first step of
    80 overflows dy/dt = s·eʸ, is rejected, and must not NaN the gradient."""
    t = np.linspace(0.0, 0.5, 6).astype(np.float32)

    def grad(first_step):
        scale = torch.tensor(1.0, requires_grad=True)
        sol, stats = odeint_with_stats(
            lambda tt, y: scale * torch.exp(y), torch.zeros(3), t, rtol=1e-3,
            atol=1e-6, method="dopri5",
            options={"first_step": first_step, "max_steps": 64})
        sol.sum().backward()
        return float(scale.grad), stats

    g_overflow, stats = grad(80.0)
    g_clean, _ = grad(0.01)
    assert stats.n_rejected >= 1 and stats.success
    assert np.isfinite(g_overflow) and np.isfinite(g_clean)
    np.testing.assert_allclose(g_overflow, g_clean, rtol=5e-2)

    def j_loss(scale):
        return jnp.sum(j_odeint(lambda tt, y: scale * jnp.exp(y),
                                jnp.zeros(3), jnp.asarray(t), rtol=1e-3,
                                atol=1e-6, method="dopri5",
                                options={"first_step": 80.0,
                                         "max_steps": 64}))

    np.testing.assert_allclose(g_overflow, float(jax.grad(j_loss)(1.0)),
                               rtol=1e-4)


def test_differentiable_solve_repeats_the_inference_solve():
    """Same answers and NFE bit for bit; the gradient flows through t0, t1
    and dt (the controller) and through the initial-step heuristic."""
    a = torch.as_tensor(np.random.RandomState(0).randn(6, 6)
                        .astype(np.float32)) * 0.5
    y0 = torch.ones(6, 2)
    t = np.linspace(0.0, 2.0, 9).astype(np.float32)
    scale = torch.tensor(1.0, requires_grad=True)
    sol, st = odeint_with_stats(lambda tt, y: scale * (a @ y), y0, t,
                                rtol=1e-5, atol=1e-7, method="dopri5")
    with torch.no_grad():
        ref, st_ref = odeint_with_stats(lambda tt, y: a @ y, y0, t,
                                        rtol=1e-5, atol=1e-7, method="dopri5",
                                        options={"differentiable": False})
    assert torch.equal(sol.detach(), ref)
    assert st._replace(host_syncs=0) == st_ref._replace(host_syncs=0)
    assert sol.requires_grad and not ref.requires_grad
    # against the closed form d/ds (e^{s·a·T} y0) at s = 1, T = 2
    sol[-1].sum().backward()
    at = a.double() * 2.0
    exact = float((at @ torch.matrix_exp(at) @ y0.double()).sum())
    assert abs(float(scale.grad) - exact) <= 1e-3 * abs(exact)


def test_differentiable_budget_runs_out_loudly():
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    y0 = torch.ones(4, requires_grad=True)
    sol, stats = odeint_with_stats(lambda tt, y: y ** 2 + 1.0, y0, t,
                                   rtol=1e-6, atol=1e-8, method="dopri5",
                                   options={"max_steps": 6})
    assert stats.success is False
    assert stats.n_accepted + stats.n_rejected == 6
    assert torch.equal(sol[0], y0) and torch.isnan(sol[-1]).all()
    assert sol.shape == (10, 4)


def test_operator_cotangents_coo_nan_and_fused_dense_nan():
    """COO and the dense fused kernel poison their operator's cotangent with
    NaN (the JAX package's policy); the supported cotangents stay finite."""
    rng = np.random.RandomState(0)
    m = sp.random(40, 40, density=0.1, random_state=rng, format="csr")
    op = as_operator(m, sparse=True)
    vals = op.vals.clone().requires_grad_()
    x = torch.tensor(rng.randn(40, 3).astype(np.float32), requires_grad=True)
    gv, gx = torch.autograd.grad(matvec(op._replace(vals=vals), x).sum(),
                                 (vals, x))
    assert torch.isnan(gv).all() and torch.isfinite(gx).all()
    # K1's backward is K1 over the transpose: a non-symmetric check
    np.testing.assert_allclose(gx.numpy(), np.ones((40, 3)) * np.asarray(
        m.sum(0)).reshape(-1, 1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        matvec(op.transpose(), torch.ones(40, 3)).numpy(), gx.numpy(),
        rtol=1e-6)
    a = torch.tensor(rng.rand(16, 16).astype(np.float32), requires_grad=True)
    h = torch.tensor(rng.randn(16, 8).astype(np.float32), requires_grad=True)
    w, b = torch.as_tensor(rng.randn(8, 8).astype(np.float32)), torch.zeros(8)
    da, dh = torch.autograd.grad(fused_rhs.fused_rhs(a, h, w, b).sum(), (a, h))
    assert torch.isnan(da).all() and torch.isfinite(dh).all()


def test_k2_backward_matches_autograd_of_the_plain_version():
    rng = np.random.RandomState(1)
    a, h, w, b = (torch.as_tensor(v) for v in (
        rng.rand(30, 30).astype(np.float32), rng.randn(30, 6).astype(np.float32),
        rng.randn(6, 6).astype(np.float32), rng.randn(6).astype(np.float32)))
    g = torch.as_tensor(rng.randn(30, 6).astype(np.float32))
    ins = [t.clone().requires_grad_() for t in (h, w, b)]
    ref = torch.autograd.grad((fused_rhs.fused_rhs_plain(a, *ins) * g).sum(),
                              ins)
    ins = [t.clone().requires_grad_() for t in (h, w, b)]
    got = torch.autograd.grad((fused_rhs.fused_rhs(a, *ins) * g).sum(), ins)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.024])
def test_torch_adam_matches_jax_torch_adam(weight_decay):
    """The twin of ``tests/test_optim_parity.py``: 5 steps of a fixed
    gradient sequence through the port's Adam and the JAX package's chain."""
    rng = np.random.RandomState(0)
    w0 = rng.randn(4, 3).astype(np.float32)
    grads = [rng.randn(4, 3).astype(np.float32) for _ in range(5)]
    wt = torch.tensor(w0.copy(), requires_grad=True)
    opt = torch_adam([wt], 0.01, weight_decay)
    opt_j = j_torch_adam(0.01, weight_decay)
    wj = jnp.asarray(w0)
    state = opt_j.init(wj)
    for g in grads:
        wt.grad = torch.tensor(g)
        opt.step()
        updates, state = opt_j.update(jnp.asarray(g), state, wj)
        wj = wj + updates
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=1e-5, atol=1e-6)


def test_make_sgd_step_applies_the_update_and_returns_detached_losses():
    w = torch.nn.Parameter(torch.tensor([2.0, -1.0]))
    opt = torch_adam([w], 0.1)
    step = make_sgd_step(opt, lambda target: (l1_loss(w, target),
                                              relative_l1(w, target)))
    loss, rel = step(torch.tensor([1.0, 1.0]))
    assert float(loss) == 1.5 and float(rel) == 1.5
    assert not loss.requires_grad
    np.testing.assert_allclose(w.detach().numpy(), [1.9, -0.9], rtol=1e-6)


@pytest.mark.parametrize("kind", ["lap", "norm_lap", "kipf", "norm_adj"])
def test_build_dynamics_operator_bit_equal_to_jax(kind):
    adj = generators.build_network("grid", 49)
    got = operators.build_dynamics_operator(adj, kind)
    assert got.dtype == np.float32
    assert np.array_equal(got, j_operators.build_dynamics_operator(adj, kind))
    with pytest.raises(ValueError, match="unknown operator kind"):
        operators.build_dynamics_operator(adj, "laplace")


def test_dropout_mask_and_the_dropout_forward():
    g = torch.Generator().manual_seed(3)
    m = dropout_mask(g, (500, 20), 0.25)
    assert set(np.unique(m.numpy()).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((m == 0).float().mean()) - 0.25) < 0.02
    assert torch.equal(m, dropout_mask(torch.Generator().manual_seed(3),
                                       (500, 20), 0.25))
    lap = operators.normalized_laplacian(generators.build_network("grid", 36))
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 8, 1)
    x = torch.rand(36, 1, generator=torch.Generator().manual_seed(1))
    kw = dict(KW, dropout=0.3)
    out1, _ = ndcn_forward(model, as_operator(lap), [0.0, 0.5, 1.0], x,
                           rng=torch.Generator().manual_seed(5), **kw)
    out2, _ = ndcn_forward(model, as_operator(lap), [0.0, 0.5, 1.0], x,
                           rng=torch.Generator().manual_seed(5), **kw)
    plain, _ = ndcn_forward(model, as_operator(lap), [0.0, 0.5, 1.0], x, **kw)
    assert torch.equal(out1, out2) and not torch.equal(out1, plain)
    out1.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    # no fused kernel takes a dropout mask: True refuses, "auto" falls back
    with pytest.raises(ValueError, match="dropout 0"):
        ndcn_forward(model, as_operator(lap), [0.0, 0.5], x, fused=True,
                     rng=torch.Generator(), **kw)
    ndcn_forward(model, as_operator(lap), [0.0, 0.5], x, fused="auto",
                 rng=torch.Generator(), **kw)


def test_budget_probe_and_elastic_rollback():
    class Stats:
        n_accepted, n_rejected = 5, 1

    assert probe_step_budget(lambda: Stats) == 32      # 4·6 + 8 → 32
    assert probe_step_budget(lambda: Stats, floor=8, headroom=2.5, slack=4,
                             quantum=4) == 20
    state = {"w": torch.ones(2)}
    el = ElasticBudget(8, max_retries=2)
    el.snapshot(4, "rng4", state)
    state["w"] += 1.0                     # later in-place updates
    assert not el.exhausted(1.0) and el.exhausted(float("nan"))
    assert el.exhausted([0.5, float("inf")])
    cursor, rng, snap = el.rollback()
    assert (cursor, rng, el.max_steps) == (4, "rng4", 16)
    assert torch.equal(snap["w"], torch.ones(2))
    el.rollback()
    with pytest.raises(SystemExit, match="divergence"):
        el.rollback()
    assert not ElasticBudget(8, enabled=False).exhausted(float("nan"))


@pytest.mark.parametrize("fmt", ["dense", "coo", "bsr"])
def test_heat_experiment_trains_on_the_cpu(fmt, capsys):
    """The twin of ``tests/test_solvers.py``'s experiment test, per operator
    format; the progress lines are the JAX experiment's."""
    argv = ["--n", "36", "--time_tick", "8", "--niters", "4", "--test_freq",
            "4", "--method", "dopri5", "--max_steps", "32", "--platform",
            "cpu"]
    if fmt != "dense":
        argv += ["--sparse", "--sparse_format", fmt]
    out = run("heat", build_parser("t").parse_args(argv))
    assert np.isfinite(out["final"]["abs_error"])
    assert out["max_steps"] == 32 and out["device"] == "cpu"
    assert "Iter 0004| Train Loss" in capsys.readouterr().out


def test_heat_experiment_auto_budget_and_refusals():
    out = run("heat", build_parser("t").parse_args(
        ["--n", "25", "--time_tick", "6", "--niters", "2", "--test_freq", "2",
         "--method", "dopri5", "--platform", "cpu", "--fused_kernel"]))
    assert out["max_steps"] >= 8 and np.isfinite(out["final"]["abs_error"])
    base = ["--n", "25", "--platform", "cpu"]
    for extra, item in ((["--method", "tsit5"], "item 5"),
                        (["--method", "dopri5", "--replicas", "2"], "item 8"),
                        (["--method", "dopri5", "--scan_chunk", "4"],
                         "item 4"),
                        (["--method", "dopri5", "--baseline", "gru_gnn"],
                         "item 7")):
        with pytest.raises(NotImplementedError, match=item):
            run("heat", build_parser("t").parse_args(base + extra))
    with pytest.raises(NotImplementedError, match="item 3"):
        run("gene", build_parser("t").parse_args(
            base + ["--method", "dopri5", "--network", "random"]))
    # gene on ELL (the default sparse format) and euler (the default method)
    # run: the fixed-grid solve takes the fixed budget
    out = run("gene", build_parser("t").parse_args(
        base + ["--time_tick", "6", "--niters", "2", "--test_freq", "2",
                "--sparse"]))
    assert out["max_steps"] == 256 and np.isfinite(out["final"]["abs_error"])
    with pytest.raises(NotImplementedError, match="item 4"):
        run("heat", build_parser("t").parse_args(
            base + ["--method", "dopri5", "--precision", "high"]))


@pytest.mark.parametrize("flag", ["--kernel_precision", "--emission_precision",
                                  "--residual_precision"])
def test_heat_experiment_runs_each_precision_lever(flag):
    """The three bf16 levers run in the heat experiment (COO operator, so that the
    kernel lever reaches K1), close to the f32 run, and the kernel switch is
    restored afterwards."""
    from ndcn_tpu_torch.kernels import coo_spmv

    argv = ["--n", "36", "--time_tick", "8", "--niters", "4", "--test_freq",
            "4", "--method", "dopri5", "--max_steps", "32", "--platform",
            "cpu", "--sparse", "--sparse_format", "coo"]
    ref = run("heat", build_parser("t").parse_args(argv))
    out = run("heat", build_parser("t").parse_args(argv + [flag, "bf16"]))
    assert coo_spmv.GATHER_BF16 is False
    got, want = out["final"]["train_loss"], ref["final"]["train_loss"]
    assert np.isfinite(got) and got != want
    assert abs(got - want) <= 2e-2 * abs(want)


def test_emission_precision_off_the_adaptive_path_is_refused():
    with pytest.raises(SystemExit, match="silent"):
        run("heat", build_parser("t").parse_args(
            ["--n", "25", "--platform", "cpu", "--method", "dopri5",
             "--adjoint", "--emission_precision", "bf16"]))
    with pytest.raises(SystemExit, match="silent"):
        run("heat", build_parser("t").parse_args(
            ["--n", "25", "--platform", "cpu", "--method", "euler",
             "--emission_precision", "bf16"]))
