"""The scale path on the CPU, against the JAX package: the feature-major SpMV
(K1-fm and K5 through their plain versions), the feature-major solve, the
bf16 levers, the scale experiment and the microbenchmarks' reduce.

Inputs come from numpy seeds; weights cross through
``convert.params_from_jax``. The JAX package runs as its own tests run it:
``spmv_T`` through Pallas interpret mode, and the model with
``use_tiled_kernel`` monkeypatched True on tile-packed operators (the port's
seam is monkeypatched the same way). Bars:
- ``spmv_T``, forward and gradient, port against JAX: max|Δ|/max|y| <= 1e-5
  in split2 (JAX's two-term bf16 split is ~2^-17 per product), <= 1e-4 in
  bf16 (the same rounded products, summed in another order); port bf16
  against port fp32 <= 2e-2 (one bf16 rounding of the state and of A);
- the feature-major dopri5 train step, port against JAX: equal NFE, loss
  within 1e-5 relative, gradients within 1e-4 rel-L1; port feature-major
  against port (n, d) within 1e-3 on the loss (the error norm counts the pad
  rows);
- emission and residual dtype bf16, port against JAX: equal NFE, loss within
  1e-3, gradients within 2e-2 rel-L1. The two packages round values that
  differ in their last fp32 bits, so a few roundings land on the other side
  (2^-8 each); the control weight's gradient, a sum over those rounded
  residuals, differs by up to 1.2e-2 (nd, seed 0), the rest by <= 7e-3;
- layouts against each other (both rtol 0.01 solves with their own step
  sequences): outputs within 1e-2 rel-L1.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ndcn_tpu.graph.sparse as j_gs
import ndcn_tpu.kernels.coo_spmv as j_ck
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import sparse as gs
from ndcn_tpu_torch.kernels import coo_spmv as ck
from ndcn_tpu_torch.models import ndcn as m
from ndcn_tpu_torch.models import ndcn_forward

LAYERS = ("enc1", "enc2", "wt", "dec")


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _power_law_coo(n, m_edges, seed, d=20):
    """Row-sorted COO with hub rows and empty rows (the JAX kernel tests'
    ``_random_power_law_coo``), a state and a cotangent."""
    rng = np.random.RandomState(seed)
    rows = rng.zipf(1.5, m_edges) % n
    cols = rng.randint(0, n, m_edges)
    vals = rng.randn(m_edges).astype(np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a, rng.randn(n, d).astype(np.float32), \
        rng.randn(n, d).astype(np.float32)


def _feature_major(x):
    d = x.shape[1]
    return np.ascontiguousarray(
        np.pad(x, ((0, 0), (0, ck.sublane_pad(d) - d))).T)


def _spmv_T_both(a, xT, ct, wide, bf16, monkeypatch):
    """(port yT, port dxT, JAX yT, JAX dxT) in one gather mode."""
    monkeypatch.setattr(ck, "GATHER_WIDE", wide)
    monkeypatch.setattr(ck, "GATHER_BF16", bf16)
    monkeypatch.setattr(j_ck, "GATHER_WIDE", wide)
    monkeypatch.setattr(j_ck, "GATHER_BF16", bf16)
    op = gs.from_scipy_coo(a)
    x = torch.as_tensor(xT).requires_grad_()
    y = ck.spmv_T(op, x)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), x)
    jop = j_gs.from_scipy_coo(a, tiled=True)
    jy = j_ck.spmv_T(jop.tiles, jop.tiles_t, jnp.asarray(xT))
    jdx = jax.grad(lambda xx: jnp.sum(
        j_ck.spmv_T(jop.tiles, jop.tiles_t, xx) * jnp.asarray(ct)))(
        jnp.asarray(xT))
    return y.detach().numpy(), dx.numpy(), np.asarray(jy), np.asarray(jdx)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_spmv_T_matches_jax_spmv_T(wide, bf16, monkeypatch):
    a, x, g = _power_law_coo(300, 3000, seed=4)
    xT, ct = _feature_major(x), _feature_major(g)
    y, dx, jy, jdx = _spmv_T_both(a, xT, ct, wide, bf16, monkeypatch)
    tol = 1e-4 if bf16 else 1e-5
    assert y.shape == (24, 300) and dx.shape == (24, 300)
    assert max_rel(y, jy) <= tol and max_rel(dx, jdx) <= tol
    # the zero pad rows stay zero, forward and backward
    assert not y[20:].any() and not dx[20:].any()
    dense = a.toarray()
    ref = (dense @ x.astype(np.float64)).T
    assert max_rel(y[:20], ref) <= (2e-2 if bf16 else 1e-5)
    assert max_rel(dx[:20], (dense.T @ g.astype(np.float64)).T) <= (
        2e-2 if bf16 else 1e-5)


def test_spmv_T_bf16_against_fp32_and_wide_against_narrow(monkeypatch):
    a, x, _ = _power_law_coo(300, 3000, seed=5)
    op = gs.from_scipy_coo(a)
    xT = torch.as_tensor(_feature_major(x))
    got = {}
    for wide in (False, True):
        for bf16 in (False, True):
            monkeypatch.setattr(ck, "GATHER_WIDE", wide)
            monkeypatch.setattr(ck, "GATHER_BF16", bf16)
            got[wide, bf16] = ck.spmv_T(op, xT).numpy()
    assert max_rel(got[False, True], got[False, False]) <= 2e-2
    assert max_rel(got[False, True], got[False, False]) > 1e-5  # it rounds
    for bf16 in (False, True):
        assert max_rel(got[True, bf16], got[False, bf16]) <= 1e-6


def test_spmv_T_operator_cotangent_is_nan_and_shapes_are_checked():
    a, x, _ = _power_law_coo(140, 900, seed=1, d=4)
    op = gs.from_scipy_coo(a)
    vals = op.vals.clone().requires_grad_()
    xT = torch.as_tensor(_feature_major(x))
    (gv,) = torch.autograd.grad(
        (ck.spmv_T(op._replace(vals=vals), xT) ** 2).sum(), vals)
    assert torch.isnan(gv).all()
    with pytest.raises(ValueError, match="shape"):
        ck.spmv_T(op, xT.t().contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ck.spmv_T(op, torch.zeros(140, 8).t())
    with pytest.raises(TypeError, match="float32"):
        ck.spmv_T(op, xT.double())


@pytest.mark.parametrize("d,d_sub", [(1, 8), (8, 8), (9, 16), (20, 24),
                                     (128, 128), (130, 136)])
def test_sublane_pad_bit_equal_to_jax(d, d_sub):
    assert ck.sublane_pad(d) == j_ck.sublane_pad(d) == d_sub


@pytest.mark.parametrize("bf16", [False, True])
def test_row_major_k1_bf16_matches_jax_tiled_spmv(bf16, monkeypatch):
    """GATHER_BF16 reaches the (n, d) layout's K1 too, as JAX's tiled_spmv
    goes through _spmv_T; a width-1 state is never rounded."""
    a, x, g = _power_law_coo(300, 3000, seed=6)
    monkeypatch.setattr(ck, "GATHER_BF16", bf16)
    monkeypatch.setattr(j_ck, "GATHER_BF16", bf16)
    op = gs.from_scipy_coo(a)
    xt = torch.as_tensor(x).requires_grad_()
    y = ck.coo_spmv(op, xt)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(g)).sum(), xt)
    jop = j_gs.from_scipy_coo(a, tiled=True)
    jy = j_ck.tiled_spmv(jop.tiles, jop.tiles_t, jnp.asarray(x))
    jdx = jax.grad(lambda xx: jnp.sum(j_ck.tiled_spmv(
        jop.tiles, jop.tiles_t, xx) * jnp.asarray(g)))(jnp.asarray(x))
    tol = 1e-4 if bf16 else 1e-5
    assert max_rel(y.detach().numpy(), jy) <= tol
    assert max_rel(dx.numpy(), jdx) <= tol
    x1 = torch.as_tensor(np.ascontiguousarray(x[:, :1]))
    assert torch.equal(ck.coo_spmv(op, x1),
                       ck.coo_spmv_plain(op.rows, op.cols, op.vals, x1, op.n))


def test_gather_precision_restores_the_switch():
    assert ck.GATHER_BF16 is False
    with ck.gather_precision(True):
        assert ck.GATHER_BF16 is True
    assert ck.GATHER_BF16 is False
    with pytest.raises(RuntimeError):
        with ck.gather_precision(True):
            raise RuntimeError("boom")
    assert ck.GATHER_BF16 is False


# ---------------------------------------------------------------- the model


def _graph90(seed=0):
    rng = np.random.RandomState(seed)
    n = 90
    dense = (rng.rand(n, n) * (rng.rand(n, n) < 0.1)).astype(np.float32)
    np.fill_diagonal(dense, 0)
    return (sp.csr_matrix(dense), rng.rand(n, 1).astype(np.float32),
            rng.rand(5, n, 1).astype(np.float32))


def _both_tiled(monkeypatch):
    monkeypatch.setattr(gs, "use_tiled_kernel", lambda op: True)
    monkeypatch.setattr(j_gs, "use_tiled_kernel", lambda: True)


def _step_both(monkeypatch, layout, emission=False, residual=False,
               terminal=False, seed=0):
    """Loss, gradients and NFE of one dopri5 train step in both packages."""
    _both_tiled(monkeypatch)
    mat, x0, target = _graph90(seed)
    vt = np.linspace(0.0, 1.0, 5).astype(np.float32)
    params = j_init_ndcn(jax.random.PRNGKey(seed), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    kw = dict(rtol=0.01, atol=0.001, method="dopri5", max_steps=24,
              layout=layout, terminal=terminal)
    jkw = dict(kw, emission_dtype=jnp.bfloat16 if emission else None,
               residual_dtype=jnp.bfloat16 if residual else None)
    kw.update(emission_dtype=torch.bfloat16 if emission else None,
              residual_dtype=torch.bfloat16 if residual else None)
    tgt = target[-1] if terminal else target
    jop = j_gs.from_scipy_coo(mat, tiled=True)

    def j_loss(p):
        out, stats = j_ndcn_forward(p, jop, jnp.asarray(vt),
                                    jnp.asarray(x0), **jkw)
        return jnp.mean(jnp.abs(out - jnp.asarray(tgt))), stats

    (j_l, j_stats), j_g = jax.value_and_grad(j_loss, has_aux=True)(params)
    out, stats = ndcn_forward(model, gs.from_scipy_coo(mat), vt,
                              torch.as_tensor(x0), **kw)
    loss = (out - torch.as_tensor(tgt)).abs().mean()
    loss.backward()
    worst = max(max(rel_l1(getattr(model, n).weight.grad.numpy().T,
                           j_g[n]["w"]),
                    rel_l1(getattr(model, n).bias.grad, j_g[n]["b"]))
                for n in LAYERS)
    return (float(loss), float(j_l), worst, stats.nfe, int(j_stats.nfe),
            model)


@pytest.mark.parametrize("seed", [0, 1])
def test_feature_major_train_step_matches_jax(seed, monkeypatch):
    loss, j_loss, worst, nfe, j_nfe, _ = _step_both(
        monkeypatch, "feature_major", seed=seed)
    assert nfe == j_nfe
    assert abs(loss - j_loss) <= 1e-5 * abs(j_loss)
    assert worst <= 1e-4


def test_feature_major_matches_nd_and_terminal(monkeypatch):
    monkeypatch.setattr(gs, "use_tiled_kernel", lambda op: True)
    mat, x0, target = _graph90()
    op = gs.from_scipy_coo(mat)
    model = params_from_jax(jax.tree_util.tree_map(
        np.asarray, j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)))
    vt = np.linspace(0.0, 1.0, 5).astype(np.float32)
    kw = dict(rtol=0.01, atol=0.001, method="dopri5", max_steps=24)
    losses = {}
    for layout in ("nd", "feature_major"):
        out, stats = ndcn_forward(model, op, vt, torch.as_tensor(x0),
                                  layout=layout, **kw)
        assert stats.success and out.shape == (5, 90, 1)
        losses[layout] = float((out - torch.as_tensor(target)).abs().mean())
    assert abs(losses["feature_major"] - losses["nd"]) <= 1e-3 * losses["nd"]
    # inference and terminal variants decode through the transpose correctly
    for extra in (dict(nondiff=True), dict(terminal=True)):
        out_t, _ = ndcn_forward(model, op, vt, torch.as_tensor(x0),
                                layout="feature_major", **kw, **extra)
        out_n, _ = ndcn_forward(model, op, vt, torch.as_tensor(x0),
                                layout="nd", **kw, **extra)
        assert out_t.shape == out_n.shape
        assert rel_l1(out_t.detach(), out_n.detach()) <= 1e-2


def test_feature_major_terminal_matches_jax(monkeypatch):
    loss, j_loss, worst, nfe, j_nfe, _ = _step_both(
        monkeypatch, "feature_major", terminal=True)
    assert nfe == j_nfe and abs(loss - j_loss) <= 1e-5 * abs(j_loss)
    assert worst <= 1e-4


@pytest.mark.parametrize("layout", ["nd", "feature_major"])
@pytest.mark.parametrize("emission,residual", [(True, False), (False, True),
                                               (True, True)])
def test_bf16_levers_match_jax(layout, emission, residual, monkeypatch):
    loss, j_loss, worst, nfe, j_nfe, _ = _step_both(
        monkeypatch, layout, emission=emission, residual=residual)
    assert nfe == j_nfe
    assert abs(loss - j_loss) <= 1e-3 * abs(j_loss)
    assert worst <= 2e-2


def test_feature_major_kernel_bf16_trains_close_to_fp32(monkeypatch):
    """--kernel_precision bf16 on the feature-major step. (The JAX package's
    bf16 Pallas contraction does not run inside its CPU train step, so the
    kernel-level bf16 parity is held by test_spmv_T_matches_jax_spmv_T.)"""
    monkeypatch.setattr(gs, "use_tiled_kernel", lambda op: True)
    mat, x0, target = _graph90()
    model = params_from_jax(jax.tree_util.tree_map(
        np.asarray, j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)))
    losses = {}
    for bf16 in (False, True):
        monkeypatch.setattr(ck, "GATHER_BF16", bf16)
        out, stats = ndcn_forward(model, gs.from_scipy_coo(mat),
                                  np.linspace(0.0, 1.0, 5),
                                  torch.as_tensor(x0), rtol=0.01, atol=0.001,
                                  method="dopri5", max_steps=24,
                                  layout="feature_major")
        assert stats.success
        losses[bf16] = float((out - torch.as_tensor(target)).abs().mean())
    assert 0 < abs(losses[True] - losses[False]) <= 1e-2 * losses[False]


def test_feature_major_predicate_mirrors_jax(monkeypatch):
    rng = np.random.RandomState(1)
    dense = (rng.rand(40, 40) * (rng.rand(40, 40) < 0.2)).astype(np.float32)
    op = gs.from_scipy_coo(sp.csr_matrix(dense))
    dense_op = gs.from_dense(dense)
    h = torch.zeros(40, 20)
    monkeypatch.setattr(gs, "use_tiled_kernel", lambda op: True)
    ok = m._feature_major_ok
    assert ok(op, h, False, False, 0.0, False)
    assert not ok(dense_op, h, False, False, 0.0, False)
    assert not ok(op, h, True, False, 0.0, False)
    assert not ok(op, h, False, True, 0.0, False)
    assert not ok(op, h, False, False, 0.5, False)
    assert not ok(op, h, False, False, 0.0, "auto")
    assert not ok(op, torch.zeros(40, 128), False, False, 0.0, False)
    assert not ok(op, torch.zeros(40, 1), False, False, 0.0, False)
    monkeypatch.undo()
    # the seam: a COO operator on the CPU does not serve the kernels
    assert not gs.use_tiled_kernel(op)
    assert not ok(op, h, False, False, 0.0, False)
    with pytest.raises(ValueError, match="feature_major"):
        m.resolve_layout("feature_major", op, h)
    with pytest.raises(ValueError, match="unknown layout"):
        m.resolve_layout("nm", op, h)


def test_layout_auto_picks_feature_major_at_the_node_threshold(monkeypatch):
    monkeypatch.setattr(gs, "use_tiled_kernel", lambda op: True)
    mat, x0, _ = _graph90(2)
    op = gs.from_scipy_coo(mat)
    model = params_from_jax(jax.tree_util.tree_map(
        np.asarray, j_init_ndcn(jax.random.PRNGKey(0), 1, 12, 1)))
    calls = []
    orig = m.ode_func_T

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(m, "ode_func_T", spy)
    vt = np.linspace(0.0, 1.0, 4).astype(np.float32)
    kw = dict(rtol=0.01, atol=0.001, method="dopri5", nondiff=True)
    assert m._FEATURE_MAJOR_AUTO_NODES == 500_000
    monkeypatch.setattr(m, "_FEATURE_MAJOR_AUTO_NODES", 91)
    out_nd, _ = ndcn_forward(model, op, vt, torch.as_tensor(x0), **kw)
    assert not calls, "below the threshold, auto stays nd"
    monkeypatch.setattr(m, "_FEATURE_MAJOR_AUTO_NODES", 90)
    out_fm, _ = ndcn_forward(model, op, vt, torch.as_tensor(x0), **kw)
    assert calls, "at the threshold, auto picks feature_major"
    assert rel_l1(out_fm, out_nd) <= 1e-2


def test_emission_readout_keeps_a_readout_sized_trajectory():
    from ndcn_tpu_torch.ode import odeint_with_stats

    a = torch.as_tensor(np.random.RandomState(0).randn(6, 6)
                        .astype(np.float32)) * 0.3
    w = torch.as_tensor(np.random.RandomState(1).randn(2, 6)
                        .astype(np.float32))
    y0 = torch.ones(6, 3)
    t = [0.0, 0.3, 0.7, 1.0]
    opts = dict(differentiable=True)
    full, st = odeint_with_stats(lambda s, y: a @ y, y0, t, rtol=1e-5,
                                 atol=1e-7, method="dopri5", options=opts)
    ro, st2 = odeint_with_stats(lambda s, y: a @ y, y0, t, rtol=1e-5,
                                atol=1e-7, method="dopri5",
                                options=dict(opts, emission_readout=lambda y:
                                             w @ y))
    assert ro.shape == (4, 2, 3) and st.nfe == st2.nfe
    assert max_rel(ro.detach(), (w @ full).detach()) <= 1e-6
    bf, _ = odeint_with_stats(lambda s, y: a @ y, y0, t, rtol=1e-5,
                              atol=1e-7, method="dopri5",
                              options=dict(opts, emission_dtype=torch.bfloat16))
    assert bf.dtype == torch.float32
    assert 0 < max_rel(bf.detach(), full.detach()) <= 1e-2
    with pytest.raises(ValueError, match="differentiable solve only"):
        odeint_with_stats(lambda s, y: a @ y, y0, t, method="dopri5",
                          options=dict(differentiable=False,
                                       emission_dtype=torch.bfloat16))
