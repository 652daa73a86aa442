"""The scan path (``ode.adaptive.solve_scan``, the solve's ``scan`` option)
and ``--scan_chunk`` (``train.chunk``) on the CPU, against the JAX package.

Bars:
- ``solve_scan`` against JAX's ``solve_scan``: the stats equal, the
  solution within 1e-5 rel-L1, the gradients within 1e-4 (the same float32
  program, its sums in another order);
- against the port's host loop (``adaptive.solve``): NFE and counts equal,
  the solution within 1e-6 (the readout's matmul sums the same terms in
  another order), the gradients within 1e-5;
- ``ndcn_grads_grid400``: loss 1e-4, gradients 1e-3 rel-L1 (the fixture's
  own bars);
- the heat driver with ``--scan_chunk 2``: its boundary losses within 1e-4
  of the JAX driver's and 1e-5 of the port's unchunked run, at the same
  log iterations (at this size; training runs that differ in their last
  bits part at the solver's discrete decisions after some ten steps).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.experiments import dynamics as j_dynamics
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.ode import odeint as j_odeint
from ndcn_tpu.ode import odeint_with_stats as j_odeint_with_stats
from ndcn_tpu.train.budget import scan_train_bytes as j_scan_train_bytes
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.experiments.dynamics import (build_parser, nan_unless_ok,
                                                 run)
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import odeint, odeint_with_stats
from ndcn_tpu_torch.train import budget
from ndcn_tpu_torch.train.losses import l1_loss
from ndcn_tpu_torch.train.optim import CapturableAdam, torch_adam

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
KW = dict(rtol=0.01, atol=0.001, method="dopri5")
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


# ------------------------------------------------------------- the solve


@pytest.mark.parametrize("method", ["dopri5"])
def test_solve_scan_matches_jax_solve_scan_on_linear2d(method):
    """linear2d (y' = y Aᵀ over 50 points, its fixture's dopri5): the
    port's bounded solve and JAX's ``solve_scan`` take the same attempts;
    the solution and its gradient (for A and y0) agree. (tsit5 on this
    system's float32 state at rtol 1e-5 takes one rejected attempt more
    than JAX in the port's host loop as well: its first attempt's
    embedded error is at float32 rounding, and the order of the two
    packages' sums sets the next step; on a float64 state the counts are
    equal, ``test_torch_solvers``.)"""
    f = dict(np.load(os.path.join(FIX, "linear2d_dopri5.npz")))
    a = torch.tensor(f["a"], requires_grad=True)
    y0 = torch.tensor(f["y0"], requires_grad=True)
    w = np.random.RandomState(0).randn(*f["sol"].shape).astype(np.float32)
    sol, st = odeint_with_stats(lambda t, y: y @ a.T, y0, f["t"], rtol=1e-5,
                                atol=1e-7, method=method,
                                options=dict(SCAN, max_steps=96))
    (sol * torch.as_tensor(w)).sum().backward()

    def j_loss(aj, yj):
        s, jst = j_odeint_with_stats(lambda t, y: y @ aj.T, yj,
                                     jnp.asarray(f["t"]), rtol=1e-5,
                                     atol=1e-7, method=method,
                                     options={"max_steps": 96})
        return jnp.sum(s * w), (s, jst)

    (_, (j_sol, j_st)), (ga, gy) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(f["a"]),
                                              jnp.asarray(f["y0"]))
    assert _stats(st) == _stats(j_st)
    assert rel_l1(sol.detach(), j_sol) <= 1e-5
    assert rel_l1(a.grad, ga) <= 1e-4 and rel_l1(y0.grad, gy) <= 1e-4


def _grid400():
    f = dict(np.load(os.path.join(FIX, "ndcn_grads_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in LAYERS}
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    return f, tree, lap


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_solve_scan_matches_jax_on_the_grid400_ndcn(method):
    """The grid400 NDCN (hidden 20, dense operator) through the bounded
    solve against JAX's ``ndcn_forward`` (its scan path): the stats equal,
    the loss within 1e-5 and every gradient within 1e-4 rel-L1."""
    from ndcn_tpu.graph.sparse import from_dense as j_from_dense

    f, tree, lap = _grid400()
    target = f["target"]

    def j_loss(p):
        out, stats = j_ndcn_forward(p, j_from_dense(lap), jnp.asarray(f["t"]),
                                    jnp.asarray(f["x0"]), max_steps=32,
                                    **dict(KW, method=method))
        return jnp.mean(jnp.abs(out[..., 0].T - target)), stats

    (j_val, j_st), j_grads = jax.value_and_grad(j_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = params_from_jax(tree)
    out, st = ndcn_forward(model, as_operator(lap), f["t"],
                           torch.as_tensor(f["x0"]), max_steps=32, scan=True,
                           **dict(KW, method=method))
    loss = l1_loss(out[..., 0].T, torch.as_tensor(target))
    loss.backward()
    assert _stats(st) == _stats(j_st)
    assert abs(loss.item() - float(j_val)) <= 1e-5 * abs(float(j_val))
    for n in LAYERS:
        layer = getattr(model, n)
        assert rel_l1(layer.weight.grad.numpy().T, j_grads[n]["w"]) <= 1e-4
        assert rel_l1(layer.bias.grad, j_grads[n]["b"]) <= 1e-4


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_solve_scan_matches_the_host_loop(method):
    """The bounded solve against the host loop on one input: the same
    attempts (NFE, accepted, rejected), the solution within 1e-6 and the
    gradients (through the controller and the initial step) within 1e-5;
    its stats are device tensors and it read nothing on the host."""
    rs = np.random.RandomState(1)
    a = torch.as_tensor(rs.randn(6, 6).astype(np.float32)) * 0.5
    t = np.linspace(0.0, 2.0, 9).astype(np.float32)

    def solve(options):
        scale = torch.tensor(1.0, requires_grad=True)
        y0 = torch.ones(6, 2, requires_grad=True)
        sol, st = odeint_with_stats(lambda tt, y: scale * (a @ y), y0, t,
                                    rtol=1e-5, atol=1e-7, method=method,
                                    options=dict(options, max_steps=48))
        (sol * torch.linspace(-1.0, 1.0, 9)[:, None, None]).sum().backward()
        return sol.detach(), st, scale.grad, y0.grad

    sol, st, g_s, g_y = solve(SCAN)
    ref, st_ref, r_s, r_y = solve({})
    assert isinstance(st.nfe, torch.Tensor) and st.host_syncs == 0
    assert _stats(st) == _stats(st_ref) and st_ref.host_syncs > 0
    assert rel_l1(sol, ref) <= 1e-6
    assert rel_l1(g_s, r_s) <= 1e-5 and rel_l1(g_y, r_y) <= 1e-5


@pytest.mark.parametrize("fmt,fused", [("dense", "auto"), ("coo", False),
                                       ("bsr", True)])
def test_bounded_route_meets_the_grid400_fixture(fmt, fused):
    """``ndcn_grads_grid400`` (the reference's backprop through
    torchdiffeq) through the bounded solve on each operator."""
    f, tree, lap = _grid400()
    model = params_from_jax(tree)
    op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                     sparse=fmt != "dense", format=fmt)
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              max_steps=64, fused=fused, scan=True, **KW)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert bool(stats.success)
    ref = float(f["loss_backprop"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name in LAYERS:
        layer = getattr(model, name)
        assert rel_l1(layer.weight.grad, f[f"g_{name}_w_backprop"]) < 1e-3
        assert rel_l1(layer.bias.grad, f[f"g_{name}_b_backprop"]) < 1e-3


def test_bounded_solve_survives_an_overflowing_first_step():
    """A first step of 80 overflows dy/dt = s·eʸ and is rejected: the
    recomputation at dt = 0 (the guard) keeps the gradient finite and equal
    to ``jax.grad`` of JAX's guarded scan."""
    t = np.linspace(0.0, 0.5, 6).astype(np.float32)
    scale = torch.tensor(1.0, requires_grad=True)
    sol, stats = odeint_with_stats(
        lambda tt, y: scale * torch.exp(y), torch.zeros(3), t, rtol=1e-3,
        atol=1e-6, method="dopri5",
        options=dict(SCAN, first_step=80.0, max_steps=64))
    sol.sum().backward()
    assert int(stats.n_rejected) >= 1 and bool(stats.success)

    def j_loss(s):
        return jnp.sum(j_odeint(lambda tt, y: s * jnp.exp(y), jnp.zeros(3),
                                jnp.asarray(t), rtol=1e-3, atol=1e-6,
                                method="dopri5",
                                options={"first_step": 80.0,
                                         "max_steps": 64}))

    assert np.isfinite(float(scale.grad))
    np.testing.assert_allclose(float(scale.grad),
                               float(jax.grad(j_loss)(1.0)), rtol=1e-4)


def test_bounded_budget_runs_out_loudly():
    """A blown budget: exactly ``max_steps`` attempts, ``success`` false on
    the device, a NaN trajectory from ``odeint`` and a NaN loss whose
    backward still runs (zero gradient through the NaN's ``where``)."""
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    y0 = torch.ones(4, requires_grad=True)
    sol, stats = odeint_with_stats(lambda tt, y: y ** 2 + 1.0, y0, t,
                                   rtol=1e-6, atol=1e-8, method="dopri5",
                                   options=dict(SCAN, max_steps=6))
    assert isinstance(stats.success, torch.Tensor)
    assert not bool(stats.success)
    assert int(stats.n_accepted) + int(stats.n_rejected) == 6
    loss = nan_unless_ok(stats.success, sol.sum())
    assert torch.isnan(loss)
    loss.backward()
    assert torch.equal(y0.grad, torch.zeros(4))
    traj = odeint(lambda tt, y: y ** 2 + 1.0, torch.ones(4), t, rtol=1e-6,
                  atol=1e-8, method="dopri5",
                  options=dict(SCAN, max_steps=6))
    assert torch.isnan(traj).all()


@pytest.mark.parametrize("method,options", [
    ("dopri5", {"emission_dtype": torch.bfloat16}),
    ("tsit5", {"emission_readout": "sum"}),
    ("dopri5", {"emission_dtype": torch.bfloat16,
                "emission_readout": "first"})])
def test_bounded_emission_levers_match_the_jax_scan_path(method, options):
    """``emission_dtype`` and ``emission_readout`` on the bounded solve
    against JAX's scan path: the same steps, the observations within bf16
    rounding (1e-2 · max|y|) or 1e-5 without it."""
    a = np.array([[-0.5, 0.3, 0.0, 0.1], [0.2, -0.4, 0.1, 0.0],
                  [0.0, 0.1, -0.3, 0.2], [0.1, 0.0, 0.2, -0.6]], np.float32)
    y0 = (np.arange(8.0) / 8.0).reshape(4, 2).astype(np.float32)
    t = [0.0, 0.3, 0.8, 1.0]
    readouts = {"sum": (lambda y: y.sum(0), lambda y: y.sum(0)),
                "first": (lambda y: y[:1], lambda y: y[:1])}
    ours, theirs = dict(options, scan=True), dict(options)
    if "emission_readout" in options:
        ours["emission_readout"], theirs["emission_readout"] = \
            readouts[options["emission_readout"]]
    if "emission_dtype" in options:
        theirs["emission_dtype"] = jnp.bfloat16
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    sol, st = odeint_with_stats(lambda tt, y: at @ y, torch.as_tensor(y0), t,
                                rtol=1e-5, atol=1e-7, method=method,
                                options=ours)
    ref, j_st = j_odeint_with_stats(lambda tt, y: aj @ y, jnp.asarray(y0),
                                    jnp.asarray(t, jnp.float32), rtol=1e-5,
                                    atol=1e-7, method=method, options=theirs)
    ref = np.asarray(ref, np.float32)
    assert _stats(st) == _stats(j_st) and sol.shape == ref.shape
    bar = 1e-2 if "emission_dtype" in options else 1e-5
    assert float(np.abs(sol.detach().numpy() - ref).max()) <= \
        bar * float(np.abs(ref).max())


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "adams", "euler"])
def test_scan_train_bytes_equals_the_jax_packages(method):
    for shape, n_obs in (((400, 20), 80), ((7, 3), 0)):
        ours = budget.scan_train_bytes(method, 12, torch.zeros(shape),
                                       n_obs=n_obs)
        theirs = j_scan_train_bytes(
            method, 12, jax.ShapeDtypeStruct(shape, jnp.float32),
            n_obs=n_obs)
        assert ours == theirs


def test_the_scan_option_refuses_what_it_does_not_take():
    """The bounded solve takes one replica: ``batched`` is refused, for
    every adaptive method. The inference solve (``differentiable=False``,
    the adjoint's), the continuous adjoint and adams, which it refused up
    to ROADMAP §1 entry 6b item 2, now run under it, and a ``node_group``
    of None is a world of one."""
    y0 = torch.ones(2, 3)

    def f(t, y):
        return -y

    for method in ("dopri5", "tsit5", "adams"):
        with pytest.raises(ValueError, match="scan=True"):
            odeint_with_stats(f, y0, [0.0, 1.0], method=method,
                              options=dict(SCAN, batched=True))
    for options in ({"differentiable": False}, {"node_group": None}):
        sol, st = odeint_with_stats(f, y0, [0.0, 1.0], method="dopri5",
                                    options=dict(SCAN, max_steps=16,
                                                 **options))
        assert st.host_syncs == 0 and bool(st.success)
        assert torch.allclose(sol[-1], y0 * np.exp(-1.0), rtol=1e-5)
    for kw in (dict(adjoint=True), dict(method="adams")):
        out, st = ndcn_forward(params_from_jax(_grid400()[1]),
                               as_operator(np.eye(400, dtype=np.float32)),
                               [0.0, 1.0], torch.ones(400, 1), scan=True,
                               max_steps=16, **dict(KW, **kw))
        assert bool(st.success) and torch.isfinite(out).all()


# ------------------------------------------------- the attempts' gate
#
# A captured step puts each attempt of the bounded solve behind a CUDA
# conditional node (``ode.graph_gate``); here a host branch on the live flag
# stands in for it: the same ``_gated`` buffers and copies, the same
# skipped work.


def _host_gate(calls):
    def gate(live, body):
        calls.append(bool(live))
        if bool(live):
            body()
    return gate


@pytest.mark.parametrize("case", ["live", "frozen", "vetoed"])
def test_gated_attempt_is_the_checkpointed_masked_attempt(case):
    """One attempt as ``_GatedAttempt`` behind a host-branch gate against
    the checkpointed masked attempt: the outputs and the gradients with
    respect to the carry, t1, dt and the parameters of the RHS and of the
    emission readout bit-equal, for a live attempt, a frozen one (skipped:
    its outputs and VJP made outside the gate) and a vetoed one (a first
    step of 80 overflows dy/dt = exp(y W + b); the recomputation rejects
    it at dt = 0)."""
    from torch.utils.checkpoint import checkpoint

    from ndcn_tpu_torch.ode import adaptive
    from ndcn_tpu_torch.ode.runge_kutta import stage_coeffs
    from ndcn_tpu_torch.ode.step_control import Controller

    rs = np.random.RandomState(3)
    w = torch.tensor(rs.randn(5, 5).astype(np.float32) * 0.3,
                     requires_grad=True)
    b = torch.tensor(rs.randn(5).astype(np.float32) * 0.1,
                     requires_grad=True)
    r = torch.tensor(rs.randn(5, 2).astype(np.float32), requires_grad=True)
    bound = [w, b, r]     # what the RHS and the readout read at each call

    def func(t, y):
        return torch.exp(y @ bound[0] + bound[1])

    def readout(s):
        return s @ bound[2]

    method = adaptive.DOPRI5_METHOD
    y = torch.tensor(rs.rand(6, 5).astype(np.float32), requires_grad=True)
    f = func(None, y).detach().requires_grad_()
    t1 = torch.tensor(0.25, requires_grad=True)
    dt = torch.tensor(80.0 if case == "vetoed" else 0.05, requires_grad=True)
    live = torch.tensor(case != "frozen")
    attempt = adaptive._masked_attempt(
        method, func, Controller(rtol=1e-3, atol=1e-6),
        stage_coeffs(method.tableau, torch.float32, y.device), True, 1,
        emission_readout=readout)
    wrt = (y, f, t1, dt, w, b, r)

    def run(apply, cots=None):
        veto = [torch.zeros((), dtype=torch.bool)]
        out = apply(veto)
        veto[0] = ~out[5]
        diff = (*out[:4], *out[6:])
        if cots is None:
            gen = torch.Generator().manual_seed(0)
            cots = [torch.randn(o.shape, generator=gen) for o in diff]
        grads = torch.autograd.grad(diff, wrt, cots, allow_unused=True)
        return ([o.detach() for o in out],
                [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, wrt)], cots)

    ref, ref_grads, cots = run(lambda veto: checkpoint(
        attempt, veto, live, t1, dt, y, f, use_reentrant=False,
        preserve_rng_state=False))
    calls = []
    with torch.no_grad():
        frozen = adaptive._frozen_attempt(readout(y),
                                          len(method.interp_init(y)))
    got, got_grads, _ = run(lambda veto: adaptive._GatedAttempt.apply(
        attempt, frozen, _host_gate(calls), veto, bound, live, t1, dt, y, f,
        *bound), cots)
    assert calls == [case != "frozen"] * 2       # forward, backward
    assert bool(ref[5]) == (case != "vetoed") and not (
        case != "live" and bool(ref[4]))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.isfinite(g).all() for g in ref_grads)
    assert all(torch.equal(a, b) for a, b in zip(got_grads, ref_grads))
    if case == "frozen":
        assert all(torch.equal(g, c) for g, c in zip(ref_grads[:4], cots))
        assert not any(g.any() for g in ref_grads[4:])


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_gated_solve_scan_is_the_masked_solve(method, monkeypatch):
    """The grid400 NDCN through the bounded solve with every attempt behind
    a host-branch gate (forward and backward), against the masked solve
    that eager steps run: the solution, the stats and every gradient
    bit-equal, most attempts frozen and skipped; against the checkpointed
    attempts (the route without ``params``): the solution and the stats
    bit-equal, the gradients within 1e-6 rel-L1 (the parameters'
    cotangents summed an attempt at a time, in another order)."""
    from ndcn_tpu_torch.ode import adaptive

    f, tree, lap = _grid400()
    scan = adaptive.solve_scan

    def run():
        model = params_from_jax(tree)
        out, st = ndcn_forward(model, as_operator(lap), f["t"],
                               torch.as_tensor(f["x0"]), max_steps=24,
                               scan=True, **dict(KW, method=method))
        l1_loss(out[..., 0].T, torch.as_tensor(f["target"])).backward()
        return (out.detach(), _stats(st),
                [p.grad.clone() for p in model.parameters()])

    masked = run()
    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(adaptive, "_attempt_gate",
                   lambda lead, groups: _host_gate(calls))
        gated = run()
    with monkeypatch.context() as mp:
        mp.setattr(adaptive, "solve_scan",
                   lambda *a, **k: scan(*a, **dict(k, params=None)))
        checkpointed = run()
    live = sum(calls[:24])
    assert len(calls) == 48 and calls[:24] == calls[24:][::-1]
    assert 0 < live < 12 and masked[1][0] == 2 + 6 * live
    assert torch.equal(gated[0], masked[0]) and gated[1] == masked[1]
    assert all(torch.equal(a, b) for a, b in zip(gated[2], masked[2]))
    assert torch.equal(checkpointed[0], masked[0])
    assert checkpointed[1] == masked[1]
    assert all(rel_l1(a, b) <= 1e-6 for a, b in zip(masked[2],
                                                    checkpointed[2]))


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_gated_inference_solve_is_the_host_loop(method, monkeypatch):
    """The bounded inference solve (``differentiable=False``, the
    adjoint's) with every attempt behind a host-branch gate gives the host
    loop's solution bit for bit, with its NFE and counts."""
    from ndcn_tpu_torch.ode import adaptive

    rs = np.random.RandomState(1)
    a = torch.as_tensor(rs.randn(6, 6).astype(np.float32)) * 0.5
    t = np.linspace(0.0, 2.0, 9).astype(np.float32)
    y0 = torch.ones(6, 2)

    def solve(options):
        return odeint_with_stats(lambda tt, y: a @ y, y0, t, rtol=1e-5,
                                 atol=1e-7, method=method,
                                 options=dict(options, max_steps=64,
                                              differentiable=False))

    calls = []
    with monkeypatch.context() as mp:
        mp.setattr(adaptive, "_attempt_gate",
                   lambda lead, groups: _host_gate(calls))
        sol, st = solve(SCAN)
    ref, st_ref = solve({})
    assert len(calls) == 64 and 0 < sum(calls) < 64
    assert _stats(st) == _stats(st_ref) and sum(calls) == int(
        st.n_accepted) + int(st.n_rejected)
    assert torch.equal(sol, ref)


def test_capturable_adam_is_adam():
    """``CapturableAdam`` (device step count, capturable arithmetic) runs
    the reference's Adam within float32 rounding, and either optimizer
    loads the other's state."""
    torch.manual_seed(0)
    w = torch.randn(5, 3, requires_grad=True)
    v = w.detach().clone().requires_grad_()
    plain = torch_adam([w], 0.01, 1e-3)
    cap = torch_adam([v], 0.01, 1e-3, capturable=True)
    assert isinstance(cap, CapturableAdam)
    for _ in range(5):
        for p, o in ((w, plain), (v, cap)):
            o.zero_grad()
            (p ** 3).sum().backward()
            o.step()
    assert float((w - v).abs().max()) <= 1e-6 * float(w.detach().abs().max())
    step = cap.state[v]["step"]
    assert isinstance(step, torch.Tensor) and float(step) == 5.0
    plain.load_state_dict(cap.state_dict())
    cap.load_state_dict(plain.state_dict())
    assert cap.state[v]["step"].device == v.device


# ------------------------------------------------------------ the driver

SMALL = ["--n", "25", "--time_tick", "6", "--niters", "4", "--test_freq",
         "2", "--method", "dopri5", "--platform", "cpu"]
_ITER = re.compile(r"Iter (\d+)\| Train Loss ([-\d.]+)")


def _boundaries(text):
    return [(int(i), float(v)) for i, v in _ITER.findall(text)]


def test_heat_scan_chunk_against_the_unchunked_run(capsys):
    """``--scan_chunk 2``: the port's boundary losses at JAX's chunk bounds
    against the port's run one step at a time (1e-5), at the same log
    iterations; one host read a chunk."""
    out = run("heat", build_parser("t").parse_args(SMALL + ["--scan_chunk",
                                                            "2"]))
    chunked = _boundaries(capsys.readouterr().out)
    assert out["scan_chunk"] == dict(chunks=2, host_reads=2, captures=0,
                                     steps=4)
    run("heat", build_parser("t").parse_args(SMALL))
    single = _boundaries(capsys.readouterr().out)
    assert [i for i, _ in chunked] == [i for i, _ in single] == [2, 4]
    for (_, a), (_, b) in zip(chunked, single):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_heat_scan_chunk_against_the_jax_driver(tmp_path, capsys):
    """The two drivers with the same argv (``--scan_chunk 2``, Adam at lr
    0 so that the weights stay JAX's init): the JAX driver's checkpoint at
    iteration 2 starts the port's run, whose one chunk to iteration 4 logs
    the JAX driver's loss there within 1e-4."""
    argv = SMALL + ["--scan_chunk", "2", "--lr", "0", "--weight_decay", "0",
                    "--max_steps", "32", "--ckpt_freq", "2"]
    j_dynamics.run("heat", j_dynamics.build_parser("t").parse_args(
        argv + ["--ckpt_dir", str(tmp_path / "jax")]))
    theirs = dict(_boundaries(capsys.readouterr().out))
    os.makedirs(tmp_path / "port")
    name = min(os.listdir(tmp_path / "jax"))          # iteration 2's
    os.replace(tmp_path / "jax" / name, tmp_path / "port" / name)
    out = run("heat", build_parser("t").parse_args(
        argv + ["--ckpt_dir", str(tmp_path / "port")]))
    ours = dict(_boundaries(capsys.readouterr().out))
    assert list(ours) == [4] and out["scan_chunk"]["chunks"] == 1
    assert abs(ours[4] - theirs[4]) <= 1e-4 * abs(theirs[4])


def test_heat_scan_chunk_resumes_bit_equal(tmp_path):
    """A chunked run cut at its checkpoint and resumed ends where the run
    in one go ends (the chunk bounds stop at ``ckpt_freq``)."""
    argv = SMALL + ["--scan_chunk", "3", "--ckpt_freq", "2"]
    whole = run("heat", build_parser("t").parse_args(
        argv + ["--ckpt_dir", str(tmp_path / "a")]))
    run("heat", build_parser("t").parse_args(
        [a if a != "4" else "2" for a in argv]
        + ["--ckpt_dir", str(tmp_path / "b")]))
    resumed = run("heat", build_parser("t").parse_args(
        argv + ["--ckpt_dir", str(tmp_path / "b")]))
    assert whole["scan_chunk"]["chunks"] == 2
    assert resumed["scan_chunk"]["steps"] == 2
    assert resumed["final"] == whole["final"]


def test_heat_scan_chunk_rolls_back_inside_a_chunk(monkeypatch, capsys):
    """A budget probed too small runs out inside the first chunk: the NaN
    loss read at its boundary rolls back, doubles the budget and builds a
    new chunk (on a card it captures again), and training ends finite."""
    monkeypatch.setattr(budget, "probe_step_budget", lambda *a, **k: 2)
    out = run("heat", build_parser("t").parse_args(SMALL + ["--scan_chunk",
                                                            "2"]))
    assert "[elastic] step budget exhausted by iter 2" in \
        capsys.readouterr().out
    assert out["elastic_retries"] >= 1 and out["max_steps"] >= 4
    assert out["scan_chunk"]["steps"] == 4 + 2 * out["elastic_retries"]
    assert np.all(np.isfinite(out["train_losses"]))


@pytest.mark.parametrize("extra", [["--method", "euler"],
                                   ["--baseline", "lstm_gnn", "--sparse",
                                    "--sparse_format", "coo"]])
def test_heat_scan_chunk_runs_the_static_paths(extra):
    """The fixed-grid methods and the temporal baselines (no adaptive
    solve: their steps are static already) train in chunks too."""
    out = run("heat", build_parser("t").parse_args(
        SMALL + ["--scan_chunk", "2", *extra]))
    assert out["scan_chunk"]["host_reads"] == 2
    assert np.all(np.isfinite(out["train_losses"]))


def test_heat_scan_chunk_profiles_one_chunk_on_copies(tmp_path):
    """``--profile_dir`` with ``--scan_chunk`` traces one chunk on copies
    of the model, Adam and the generator: the run's losses stay as they
    are without it."""
    argv = SMALL + ["--scan_chunk", "2"]
    ref = run("heat", build_parser("t").parse_args(argv))
    out = run("heat", build_parser("t").parse_args(
        argv + ["--profile_dir", str(tmp_path)]))
    assert out["train_losses"] == ref["train_losses"]
    assert out["scan_chunk"] == ref["scan_chunk"]
    assert any(os.scandir(tmp_path))


@pytest.mark.parametrize("extra", [["--adjoint"], ["--method", "adams"],
                                   ["--method", "explicit_adams"],
                                   ["--method", "fixed_adams"], ["--mesh"]])
def test_heat_scan_chunk_refuses_entry_6b(extra, tmp_path, capsys):
    """The combinations ``--scan_chunk`` refused up to ROADMAP §1 entry 6b
    item 2 now train in chunks, one host read a chunk: the continuous
    adjoint on the bounded inference solve, adams on the bounded VCABM
    solve, the fixed-grid Adams methods, and ``--mesh`` (a world of one
    here: unsharded; two gloo ranks in ``test_torch_mesh``). Their boundary
    losses are the port's unchunked run's (1e-5, and the final
    evaluation's NFE equal) and, through the JAX driver's checkpoint at
    iteration 2 with Adam at lr 0, the JAX driver's with the same flags at
    iteration 4 (1e-4)."""
    argv = SMALL + ["--scan_chunk", "2", "--max_steps", "32", *extra]
    out = run("heat", build_parser("t").parse_args(argv))
    chunked = _boundaries(capsys.readouterr().out)
    assert out["scan_chunk"] == dict(chunks=2, host_reads=2, captures=0,
                                     steps=4)
    one = run("heat", build_parser("t").parse_args(
        SMALL + ["--max_steps", "32", *extra]))
    single = _boundaries(capsys.readouterr().out)
    assert [i for i, _ in chunked] == [i for i, _ in single] == [2, 4]
    for (_, a), (_, b) in zip(chunked, single):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert out["final_nfe"] == one["final_nfe"]
    if extra == ["--mesh"]:
        return
    frozen = argv + ["--lr", "0", "--weight_decay", "0", "--ckpt_freq", "2"]
    j_dynamics.run("heat", j_dynamics.build_parser("t").parse_args(
        frozen + ["--ckpt_dir", str(tmp_path / "jax")]))
    theirs = dict(_boundaries(capsys.readouterr().out))
    os.makedirs(tmp_path / "port")
    name = min(os.listdir(tmp_path / "jax"))          # iteration 2's
    os.replace(tmp_path / "jax" / name, tmp_path / "port" / name)
    run("heat", build_parser("t").parse_args(
        frozen + ["--ckpt_dir", str(tmp_path / "port")]))
    ours = dict(_boundaries(capsys.readouterr().out))
    assert list(ours) == [4]
    assert abs(ours[4] - theirs[4]) <= 1e-4 * abs(theirs[4])
