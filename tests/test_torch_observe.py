"""The host loop's read of the observations (``ode.adaptive.solve``): every
observation an accepted step passes is evaluated in one block, from the
step's dense-output sources read out once, held against the plain read of
one observation at a time kept here (the loop as it read before).

dopri5 and tsit5, a bare and a tuple state, the emission readout and
``emission_dtype``, several observations in one step, an observation at a
step's end, steps that pass none, a budget blown mid-grid; the NDCN
forward on the feature-major readout and on the (n, d) readout in
bfloat16. Trajectories and stats equal, bit for bit; gradients within 1e-6
relative in float64 and 3e-4 in float32 (``GRAD_BOUND``: only the order in
which the observations' cotangents are summed differs); and the readout
applied at most once a source an accepted step (+ y0's), not once an
observation."""

import numpy as np
import pytest
import torch

from ndcn_tpu_torch.graph import generators, operators, sparse
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.ode import adaptive
from ndcn_tpu_torch.ode.grad_guard import forced_reject
from ndcn_tpu_torch.ode.runge_kutta import stage_coeffs
from ndcn_tpu_torch.ode.step_control import Controller
from ndcn_tpu_torch.ode.tree_math import leaves

METHODS = {"dopri5": adaptive.DOPRI5_METHOD, "tsit5": adaptive.TSIT5_METHOD}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def solve_per_observation(method, func, y0, t, ctrl, max_steps,
                          first_step=None, emission_dtype=None,
                          emission_readout=None, groups=None):
    """The host loop reading one observation at a time: the last accepted
    step's sources read out and interpolated anew for each."""
    T = t.shape[0]
    t_host = t.tolist()
    lead = leaves(y0)[0]
    t_dev = t.to(lead.device)
    coeffs = stage_coeffs(method.tableau, lead.dtype, lead.device)
    n_evals = len(method.tableau.alpha)
    rk, nfe = adaptive._init_rk_state(method, func, y0, t_dev[0], ctrl,
                                      first_step, groups=groups)

    def observe(rk, t_obs):
        interp = rk.interp
        if emission_readout is not None:
            interp = type(interp)(*(emission_readout(c) for c in interp))
        return method.interp_eval(interp, rk.t0, rk.t1, t_obs,
                                  emission_dtype)

    sol = [y0 if emission_readout is None else emission_readout(y0)]
    nacc, nrej, syncs, ok = 0, 0, 0, True
    t1_host = t_host[0]
    while len(sol) < T and nacc + nrej < max_steps and ok:
        if t_host[len(sol)] <= t1_host:
            sol.append(observe(rk, t_dev[len(sol)]))
            continue
        underflow = ~((rk.t1 + rk.dt) > rk.t1)
        new, accept, finite = adaptive._attempt_step(method, func, rk, ctrl,
                                                     coeffs, groups)
        nfe += n_evals
        t1_host, acc, under, fin = torch.stack(
            [new.t1, accept.to(new.t1.dtype), underflow.to(new.t1.dtype),
             finite.to(new.t1.dtype)]).tolist()
        syncs += 1
        rk = new if fin else forced_reject(rk, ctrl.dfactor)
        if acc:
            nacc += 1
        else:
            nrej += 1
        ok = not under
    stats = adaptive.SolveStats(nfe=nfe, n_accepted=nacc, n_rejected=nrej,
                                success=ok and len(sol) >= T,
                                host_syncs=syncs)
    return adaptive.stack_solution(sol, T), stats


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _projection(out):
    """``out``'s leaves as one (T, ...) matrix, its finite rows and a fixed
    random projection of it."""
    flat = torch.cat([leaf.reshape(leaf.shape[0], -1)
                      for leaf in leaves(out)], dim=1)
    keep = torch.isfinite(flat).all(dim=1)
    proj = torch.randn(flat.shape, generator=torch.Generator().manual_seed(7)
                       ).to(flat)
    return flat, keep, proj


def _grads(out, wrt):
    """The gradients of a fixed random projection of ``out`` (its NaN rows
    left out) with respect to ``wrt``."""
    flat, keep, proj = _projection(out)
    return torch.autograd.grad((flat[keep] * proj[keep]).sum(), wrt)


# The gradient runs through the step-size controller (the JAX scan path's
# semantics), whose sums amplify rounding: on these problems the float32
# gradient of the read of one observation at a time is up to 2.4e-4
# relative from the float64 one, and summing the observations' cotangents
# in another order moves it by up to ~8e-5. In float64 the two reads agree
# to ~4e-14.
GRAD_BOUND = {torch.float32: 3e-4, torch.float64: 1e-6}


def _close_grads(grads, ref):
    for g, r in zip(grads, ref):
        assert _rel(g, r) <= GRAD_BOUND[g.dtype], _rel(g, r)


def _same(ours, ref):
    for a, b in zip(leaves(ours), leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


class _Counting:
    """A readout that counts its calls: the tuple state's first leaf
    through (2, ...) weights, the second leaf's sum."""

    def __init__(self, w):
        self.w, self.calls = w, 0

    def __call__(self, s):
        self.calls += 1
        return (s[0] @ self.w.T, s[1].sum(dim=-1, keepdim=True))


def _linear(tuple_state, dtype=torch.float32):
    """A damped linear system (a bare (4, 3) state, or a tuple of (4, 3)
    and (4, 2)) whose matrix and initial state are leaves of the tape."""
    g = torch.Generator().manual_seed(3)

    def leaf(x):
        return x.to(dtype).requires_grad_()

    a = leaf(torch.randn(3, 3, generator=g) * 0.8 - 1.5 * torch.eye(3))
    y0 = leaf(torch.randn(4, 3, generator=g))
    if not tuple_state:
        return (lambda t, y: y @ a.T), y0, (a, y0)
    b = leaf(torch.randn(2, 3, generator=g))
    z0 = leaf(torch.randn(4, 2, generator=g))

    def func(t, y):
        return (y[0] @ a.T, torch.tanh(y[0] @ b.T) * (1.0 + t) - y[1])

    return func, (y0, z0), (a, b, y0, z0)


# each case: (grid, rtol, max_steps, first_step)
GRIDS = {
    # 40 observations in ~6 steps: several a step
    "many_a_step": (torch.linspace(0.0, 2.0, 40), 1e-3, 64, None),
    # 3 observations in ~30 steps: most steps pass none
    "none_in_most_steps": (torch.tensor([0.0, 0.5, 1.7]), 1e-7, 256, None),
    # the first step ends at 0.25 exactly and reads the observation there;
    # the budget ends after the second attempt: a NaN tail
    "at_t1_then_blown": (torch.tensor([0.0, 0.125, 0.25, 0.6, 0.9, 1.2]),
                         1e-2, 2, 0.25),
}


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("tuple_state", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_block_read_is_the_read_an_observation(name, grid, tuple_state,
                                                   dtype):
    t, rtol, max_steps, first_step = GRIDS[grid]
    ctrl = Controller(rtol=rtol, atol=rtol * 1e-2)
    runs = []
    for solve in (adaptive.solve, solve_per_observation):
        func, y0, wrt = _linear(tuple_state, dtype)
        sol, stats = solve(METHODS[name], func, y0, t.to(dtype), ctrl,
                           max_steps, first_step=first_step)
        runs.append((sol, stats, _grads(sol, wrt)))
    (sol, stats, grads), (ref, ref_stats, ref_grads) = runs
    _same(sol, ref)
    assert stats == ref_stats
    _close_grads(grads, ref_grads)
    if grid == "at_t1_then_blown":
        first = leaves(sol)[0]
        assert not stats.success and stats.n_accepted >= 1
        assert torch.isfinite(first[:3]).all()
        assert torch.isnan(first[3:]).all()
    else:
        assert stats.success


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_the_readout_runs_once_a_source_an_accepted_step(name, dtype):
    t, rtol, max_steps, _ = GRIDS["many_a_step"]
    ctrl = Controller(rtol=rtol, atol=rtol * 1e-2)
    n_sources = len(METHODS[name].interp_init(torch.zeros(1)))
    runs = []
    for solve in (adaptive.solve, solve_per_observation):
        func, y0, wrt = _linear(True)
        w = torch.randn(2, 3, generator=torch.Generator().manual_seed(5))
        readout = _Counting(w.requires_grad_())
        sol, stats = solve(METHODS[name], func, y0, t, ctrl, max_steps,
                           emission_dtype=dtype, emission_readout=readout)
        runs.append((sol, stats, readout.calls,
                     _grads(sol, (*wrt, w))))
    (sol, stats, calls, grads), (ref, ref_stats, ref_calls,
                                 ref_grads) = runs
    _same(sol, ref)
    assert stats == ref_stats and stats.success
    assert leaves(sol)[0].shape == (t.shape[0], 4, 2)
    assert leaves(sol)[0].dtype == torch.float32
    _close_grads(grads, ref_grads)
    assert calls <= n_sources * (stats.n_accepted + 1)
    assert ref_calls == n_sources * (t.shape[0] - 1) + 1
    assert calls < ref_calls / 3


def _ndcn_problem(fmt):
    """NDCN on a 6 × 6 grid's normalized Laplacian (dense or COO): the
    model, the operator, x0 (a leaf of the tape) and 24 irregular times."""
    n = 36
    adj = generators.build_network("grid", n)
    lap = (operators.normalized_laplacian(adj) if fmt == "dense" else
           operators.normalized_laplacian_sparse(adj))
    op = as_operator(lap, sparse=fmt != "dense", format=fmt)
    rng = np.random.default_rng(1)
    x0 = torch.tensor(rng.uniform(0, 5, (n, 1)), dtype=torch.float32)
    t = torch.tensor(np.sort(np.concatenate(
        [[0.0], rng.uniform(0.0, 1.0, 23)])), dtype=torch.float32)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 8, 1)
    return model, op, x0.requires_grad_(), t


@pytest.mark.parametrize("name", sorted(METHODS))
@pytest.mark.parametrize("fmt,layout,dtype", [
    ("coo", "feature_major", None),
    ("dense", "nd", torch.bfloat16),
])
def test_ndcn_forward_reads_the_same_trajectory(name, fmt, layout, dtype,
                                                monkeypatch):
    # the feature-major solve (heat1m's) needs an operator that serves the
    # SpMV kernels: the CPU tests' seam, as in test_torch_scale.py
    monkeypatch.setattr(sparse, "use_tiled_kernel", lambda op: True)
    runs = []
    for solve in (adaptive.solve, solve_per_observation):
        monkeypatch.setattr(adaptive, "solve", solve)
        model, op, x0, t = _ndcn_problem(fmt)
        out, stats = ndcn_forward(model, op, t, x0, rtol=0.01, atol=0.001,
                                  method=name, layout=layout,
                                  emission_dtype=dtype)
        wrt = (*model.parameters(), x0)
        runs.append((out, stats, _grads(out, wrt)))
    (out, stats, grads), (ref, ref_stats, ref_grads) = runs
    assert out.shape == (24, 36, 1)
    _same(out, ref)
    assert stats == ref_stats and stats.success
    _close_grads(grads, ref_grads)
