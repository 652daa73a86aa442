"""The port's remaining solvers on the CPU: tsit5, float64 time, the
fixed-grid Adams methods and VCABM (``adams``), against the
torchdiffeq-oracle fixtures, the analytic solutions and the JAX package.

Bars, the JAX package's own (``tests/test_parity.py``,
``tests/test_solvers.py``):
- ``decay_{fixed,explicit}_adams`` and the float64-time fixtures: 1e-4
  rel-L1; ``linear2d_adams``: 5e-4 (at rtol 1e-6 the oracle's own
  trajectory is 2.2e-4 off the truth); ``linear2d_adams_tight`` with
  float64 time: 1e-4;
- tsit5 against the analytic linear2d solution: 2e-3 at rtol 1e-3 (the
  tolerance's limit) and 1e-4 at rtol 1e-7.

Step counts against the JAX package's. tsit5 takes the JAX package's NFE at
rtol 1e-3, and with the reference's error weights (no cancellation in the
estimate) over 2,771 attempts; at tighter tolerances its embedded error
Σ c_i k_i, whose weights sum to zero, is within float32 rounding of the
accept boundary, and the two packages' sums in different orders differ by
one attempt in 20-50. VCABM compares error estimates from divided
differences up to order 12, which float32 makes noisy by a few per cent
(the order controller then decides near-ties by rounding, and the JAX
package's own jitted and eager solves can part): its counts are held equal
to the JAX package's on a float64 state at rtol 1e-3-1e-5, and on NDCN's
grid400 forward.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from ndcn_tpu.graph.sparse import from_dense as j_from_dense
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.ode import odeint_with_stats as j_odeint_with_stats
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_dense
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import odeint_with_stats

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
INFER = {"differentiable": False}
LAYERS = ("enc1", "enc2", "wt", "dec")


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
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _stats(s):
    return tuple(int(x) for x in s[:3])


def _linear(name, dtype=np.float32):
    """(fixture, port RHS, JAX RHS) of a linear2d fixture, y' = y Aᵀ."""
    f = load(name)
    a = f["a"].astype(dtype)
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    return f, (lambda t, y: y @ at.T), (lambda t, y: y @ aj.T)


def _truth(f):
    return np.stack([f["y0"][0] @ sla.expm(f["a"].T.astype(np.float64) * tt)
                     for tt in f["t"]])


# ------------------------------------------------------------------ tsit5


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("rtol,atol,bar", [(1e-3, 1e-5, 2e-3),
                                           (1e-7, 1e-9, 1e-4)])
def test_tsit5_converges_to_the_analytic_solution(rtol, atol, bar,
                                                  differentiable):
    f, rhs, j_rhs = _linear("linear2d_tsit5_reference_behavior")
    opts = {"differentiable": differentiable}
    sol, stats = odeint_with_stats(rhs, torch.as_tensor(f["y0"]), f["t"],
                                   rtol=rtol, atol=atol, method="tsit5",
                                   options=opts)
    assert stats.success and sol.dtype == torch.float32
    assert rel_l1(sol.detach()[:, 0, :], _truth(f)) < bar
    _, j_stats = j_odeint_with_stats(j_rhs, jnp.asarray(f["y0"]),
                                     jnp.asarray(f["t"]), rtol=rtol,
                                     atol=atol, method="tsit5", options=opts)
    if rtol == 1e-3:
        assert _stats(stats) == _stats(j_stats) == (44, 7, 0)
    else:   # see the module docstring: one attempt in 40 at the boundary
        assert abs(stats.n_accepted - int(j_stats.n_accepted)) <= 1
        assert abs(stats.nfe - int(j_stats.nfe)) <= 0.05 * stats.nfe


@pytest.mark.parametrize("differentiable", [False, True])
@pytest.mark.parametrize("rtol", [1e-5, 1e-6, 1e-8])
def test_tsit5_steps_equal_jax_on_a_float64_state(rtol, differentiable):
    """On a float32 state linear2d_dopri5's tsit5 counts part from the JAX
    package's at rtol 1e-5-1e-8: the first attempt's embedded error is at
    float32 rounding (~1e-9), so the order in which each package sums
    c_error · k sets the next step. On a float64 state (the same arrays
    cast, float64 time) the estimate carries no such noise: the counts are
    equal and the solutions within 1e-10 rel-L1."""
    f = load("linear2d_dopri5")
    a = f["a"].astype(np.float64)
    at = torch.as_tensor(a)
    y0, t = f["y0"].astype(np.float64), f["t"].astype(np.float64)
    opts = {"differentiable": differentiable, "time_dtype": "float64"}
    sol, stats = odeint_with_stats(lambda tt, y: y @ at.T,
                                   torch.as_tensor(y0), t, rtol=rtol,
                                   atol=rtol / 100, method="tsit5",
                                   options=opts)
    with jax.enable_x64(True):
        aj = jnp.asarray(a)
        ref, j_stats = j_odeint_with_stats(
            lambda tt, y: y @ aj.T, jnp.asarray(y0), jnp.asarray(t),
            rtol=rtol, atol=rtol / 100, method="tsit5", options=opts)
        ref, j_stats = np.asarray(ref), _stats(j_stats)
    assert _stats(stats) == j_stats
    assert rel_l1(sol.detach().numpy(), ref) <= 1e-10


def test_tsit5_reference_weights_take_the_jax_packages_steps():
    """The reference's error weights (sum 32/33): the controller
    micro-steps, and the port takes the JAX package's 2,646 accepted and
    125 rejected steps exactly; the state stays accurate."""
    f, rhs, j_rhs = _linear("linear2d_tsit5_reference_behavior")
    opts = dict(INFER, reference_weights=True, max_steps=1 << 20)
    sol, stats = odeint_with_stats(rhs, torch.as_tensor(f["y0"]), f["t"],
                                   rtol=1e-2, atol=1e-4, method="tsit5",
                                   options=opts)
    _, j_stats = j_odeint_with_stats(j_rhs, jnp.asarray(f["y0"]),
                                     jnp.asarray(f["t"]), rtol=1e-2,
                                     atol=1e-4, method="tsit5", options=opts)
    assert _stats(stats) == _stats(j_stats) == (16628, 2646, 125)
    assert rel_l1(sol[:, 0, :], _truth(f)) < 1e-3


@pytest.mark.parametrize("method", ["tsit5", "adams"])
def test_differentiable_solve_repeats_the_inference_solve(method):
    """Same answers and NFE bit for bit; tsit5's gradient against the closed
    form d/ds (e^{s·a·T} y0) at s = 1 (VCABM's gradient through its step
    and order controller is far from it, and held to the JAX package's
    below)."""
    a = torch.as_tensor(np.random.RandomState(0).randn(6, 6)
                        .astype(np.float32)) * 0.5
    y0 = torch.ones(6, 2)
    t = np.linspace(0.0, 2.0, 9).astype(np.float32)
    scale = torch.tensor(1.0, requires_grad=True)
    kw = dict(rtol=1e-6, atol=1e-8, method=method)
    sol, st = odeint_with_stats(lambda tt, y: scale * (a @ y), y0, t, **kw)
    with torch.no_grad():
        ref, st_ref = odeint_with_stats(lambda tt, y: a @ y, y0, t,
                                        options=INFER, **kw)
    assert torch.equal(sol.detach(), ref)
    assert st == st_ref and st.host_syncs == st.n_accepted + st.n_rejected
    sol[-1].sum().backward()
    assert np.isfinite(float(scale.grad))
    if method == "tsit5":
        at = a.double() * 2.0
        exact = float((at @ torch.matrix_exp(at) @ y0.double()).sum())
        assert abs(float(scale.grad) - exact) <= 1e-3 * abs(exact)


@pytest.mark.parametrize("rtol", [1e-3, 1e-5])
def test_adams_gradient_matches_the_jax_scan_path(rtol):
    """The gradient through VCABM's step and order controller against
    ``jax.grad`` of the JAX package's differentiable solve, on a float64
    state where both take the same steps: 1e-6 relative."""
    a = np.random.RandomState(0).randn(6, 6) * 0.5
    y0, t = np.ones((6, 2)), np.linspace(0.0, 2.0, 9)
    opts = {"time_dtype": "float64"}
    at = torch.as_tensor(a)
    scale = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    sol, stats = odeint_with_stats(lambda tt, y: scale * (at @ y),
                                   torch.as_tensor(y0), t, rtol=rtol,
                                   atol=rtol / 100, method="adams",
                                   options=opts)
    sol[-1].sum().backward()
    with jax.enable_x64(True):
        aj = jnp.asarray(a)

        def loss(s):
            out, st = j_odeint_with_stats(
                lambda tt, y: s * (aj @ y), jnp.asarray(y0), jnp.asarray(t),
                rtol=rtol, atol=rtol / 100, method="adams", options=opts)
            return out[-1].sum(), st

        (_, j_stats), grad = jax.value_and_grad(loss, has_aux=True)(1.0)
        grad, j_stats = float(grad), _stats(j_stats)
    assert _stats(stats) == j_stats
    assert abs(float(scale.grad) - grad) <= 1e-6 * abs(grad)


@pytest.mark.parametrize("options", [
    {"emission_dtype": torch.bfloat16},
    {"emission_readout": "sum"},
    {"emission_dtype": torch.bfloat16, "emission_readout": "first"},
])
def test_tsit5_emission_levers_match_the_jax_scan_path(options):
    """The differentiable tsit5 solve with the JAX scan path's emission
    levers, against ``solve_scan`` on the same input: the same steps, the
    observations within bf16 rounding (1e-2 · max|y|) or 1e-5 without it."""
    a = np.array([[-0.5, 0.3, 0.0, 0.1], [0.2, -0.4, 0.1, 0.0],
                  [0.0, 0.1, -0.3, 0.2], [0.1, 0.0, 0.2, -0.6]], np.float32)
    y0 = (np.arange(8.0) / 8.0).reshape(4, 2).astype(np.float32)
    t = [0.0, 0.3, 0.8, 1.0]
    readouts = {"sum": (lambda y: y.sum(0), lambda y: y.sum(0)),
                "first": (lambda y: y[:1], lambda y: y[:1])}
    ours, theirs = dict(options), dict(options)
    if "emission_readout" in options:
        ours["emission_readout"], theirs["emission_readout"] = \
            readouts[options["emission_readout"]]
    if "emission_dtype" in options:
        theirs["emission_dtype"] = jnp.bfloat16
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    sol, st = odeint_with_stats(lambda tt, y: at @ y, torch.as_tensor(y0), t,
                                rtol=1e-5, atol=1e-7, method="tsit5",
                                options=ours)
    ref, j_st = j_odeint_with_stats(lambda tt, y: aj @ y, jnp.asarray(y0),
                                    jnp.asarray(t, jnp.float32), rtol=1e-5,
                                    atol=1e-7, method="tsit5", options=theirs)
    ref = np.asarray(ref, np.float32)
    assert _stats(st) == _stats(j_st) and sol.shape == ref.shape
    bar = 1e-2 if "emission_dtype" in options else 1e-5
    assert float(np.abs(sol.detach().numpy() - ref).max()) <= \
        bar * float(np.abs(ref).max())


def test_float64_time_keeps_the_state_dtype_and_the_fixture():
    """dopri5 with float64 time on linear2d_dopri5: float32 state, within
    1e-4 of the oracle, and the JAX package's steps under x64."""
    f, rhs, j_rhs = _linear("linear2d_dopri5")
    opts = dict(INFER, time_dtype="float64")
    sol, stats = odeint_with_stats(rhs, torch.as_tensor(f["y0"]), f["t"],
                                   rtol=1e-7, atol=1e-9, method="dopri5",
                                   options=opts)
    assert sol.dtype == torch.float32 and rel_l1(sol, f["sol"]) < 1e-4
    with jax.enable_x64(True):
        _, j_stats = j_odeint_with_stats(
            j_rhs, jnp.asarray(f["y0"], jnp.float32),
            jnp.asarray(f["t"], jnp.float32), rtol=1e-7, atol=1e-9,
            method="dopri5", options=opts)
        j_stats = _stats(j_stats)
    assert _stats(stats) == j_stats


def test_time_dtype_is_validated():
    with pytest.raises(ValueError, match="time_dtype"):
        odeint_with_stats(lambda t, y: -y, torch.ones(2), [0.0, 1.0],
                          method="adams", options={"time_dtype": "float16"})


# ------------------------------------------------------- fixed-grid Adams


@pytest.mark.parametrize("method", ["fixed_adams", "explicit_adams"])
def test_fixed_adams_match_the_oracle_and_the_jax_package(method):
    """``decay_*`` within 1e-4 (explicit_adams at max_order 5, where the
    order-11 method is unstable, as in the JAX package's test), the JAX
    package's NFE and its trajectory within 1e-6."""
    f = load(f"decay_{method}")
    opts = {"max_order": 5} if method == "explicit_adams" else None
    sol, stats = odeint_with_stats(lambda t, y: -y, torch.as_tensor(f["y0"]),
                                   f["t"], method=method, options=opts)
    assert rel_l1(sol, f["sol"]) < 1e-4
    ref, j_stats = j_odeint_with_stats(lambda t, y: -y, jnp.asarray(f["y0"]),
                                       jnp.asarray(f["t"]), method=method,
                                       options=opts)
    assert _stats(stats) == _stats(j_stats) and stats.success
    np.testing.assert_allclose(sol.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("max_order,max_iters", [(12, 4), (3, 1), (2, 2)])
def test_fixed_adams_orders_and_bootstrap(max_order, max_iters):
    """The order clamp, the RK4 bootstrap (4 evaluations a step while the
    history is short; max_order 2 or 3 never leaves it) and the corrector's
    iterations, against the JAX package on a harmonic oscillator."""
    t = np.linspace(0.0, 3.0, 31).astype(np.float32)
    y0 = np.array([1.0, 0.0], np.float32)
    opts = {"max_order": max_order, "max_iters": max_iters}
    sol, stats = odeint_with_stats(lambda tt, y: torch.stack([y[1], -y[0]]),
                                   torch.as_tensor(y0), t,
                                   method="fixed_adams", options=opts)
    ref, j_stats = j_odeint_with_stats(
        lambda tt, y: jnp.stack([y[1], -y[0]]), jnp.asarray(y0),
        jnp.asarray(t), method="fixed_adams", options=opts)
    assert _stats(stats) == _stats(j_stats)
    np.testing.assert_allclose(sol.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(sol[:, 0].numpy(), np.cos(t), atol=5e-3)


# ------------------------------------------------------------------ VCABM


def test_adams_meets_linear2d_adams():
    f, rhs, _ = _linear("linear2d_adams")
    sol, stats = odeint_with_stats(rhs, torch.as_tensor(f["y0"]), f["t"],
                                   rtol=1e-6, atol=1e-8, method="adams",
                                   options=INFER)
    assert stats.success and rel_l1(sol, f["sol"]) < 5e-4


def test_adams_meets_linear2d_adams_tight_with_float64_time():
    f, rhs, _ = _linear("linear2d_adams_tight")
    sol, stats = odeint_with_stats(rhs, torch.as_tensor(f["y0"]), f["t"],
                                   rtol=1e-8, atol=1e-10, method="adams",
                                   options=dict(INFER, time_dtype="float64"))
    assert stats.success and sol.dtype == torch.float32
    assert rel_l1(sol, f["sol"]) < 1e-4


@pytest.mark.parametrize("rtol", [1e-3, 1e-4, 1e-5])
def test_adams_takes_the_jax_packages_steps_on_a_float64_state(rtol):
    """On a float64 state the error estimates carry no float32 noise: the
    port's VCABM takes the JAX package's accepted and rejected steps (and
    orders) and lands on its answer."""
    f = load("linear2d_adams")
    a = f["a"].astype(np.float64)
    at = torch.as_tensor(a)
    y0, t = f["y0"].astype(np.float64), f["t"].astype(np.float64)
    opts = dict(INFER, time_dtype="float64")
    sol, stats = odeint_with_stats(lambda tt, y: y @ at.T,
                                   torch.as_tensor(y0), t, rtol=rtol,
                                   atol=rtol / 100, method="adams",
                                   options=opts)
    with jax.enable_x64(True):
        aj = jnp.asarray(a)
        ref, j_stats = j_odeint_with_stats(
            lambda tt, y: y @ aj.T, jnp.asarray(y0), jnp.asarray(t),
            rtol=rtol, atol=rtol / 100, method="adams", options=opts)
        ref, j_stats = np.asarray(ref), _stats(j_stats)
    assert _stats(stats) == j_stats
    np.testing.assert_allclose(sol.numpy(), ref, rtol=0, atol=1e-10)


def test_adams_budget_runs_out_loudly():
    t = np.linspace(0.0, 5.0, 10).astype(np.float32)
    sol, stats = odeint_with_stats(lambda tt, y: y ** 2 + 1.0, torch.ones(4),
                                   t, rtol=1e-6, atol=1e-8, method="adams",
                                   options=dict(INFER, max_steps=6))
    assert stats.success is False
    assert stats.n_accepted + stats.n_rejected == 6
    assert torch.isnan(sol[-1]).all() and torch.equal(sol[0], torch.ones(4))


# ------------------------------------------------- NDCN's grid400 forward


@pytest.fixture(scope="module")
def grid400():
    f = load("ndcn_forward_grid400")
    tree = {n: {"w": f[f"{n}_w"].T, "b": f[f"{n}_b"]} for n in LAYERS}
    lap = operators.normalized_laplacian(generators.build_network("grid",
                                                                  400))
    return f, tree, lap


@pytest.mark.parametrize("method", ["tsit5", "adams", "fixed_adams",
                                    "explicit_adams"])
def test_ndcn_grid400_forward_against_the_jax_package(grid400, method):
    """The serving forward on grid400 at the oracle fixture's weights: the
    JAX package's NFE and steps, and its answer within 1e-4 rel-L1, or
    within 5e-4 where float32 rounding is amplified: explicit_adams at
    order 11 is near its stability limit there (the trajectory grows from
    0.2 to ~4e3, and the port's float32 and float64 solves part by 1.0e-4,
    ``chip_smoke.py`` [15]); the JAX package's jitted VCABM parts from its
    own eager solve by more than 1e-4, while the port's VCABM is within
    1e-5 of that eager solve and of its own float64 one, checked here."""
    f, tree, lap = grid400
    model = params_from_jax(tree)
    kw = dict(rtol=0.01, atol=0.001, method=method, nondiff=True)
    out, stats = ndcn_forward(model, from_dense(lap), f["t"],
                              torch.as_tensor(f["x0"]), **kw)
    ref, j_stats = j_ndcn_forward(
        jax.tree_util.tree_map(jnp.asarray, tree), j_from_dense(lap),
        jnp.asarray(f["t"]), jnp.asarray(f["x0"]), **kw)
    assert stats.success and _stats(stats) == _stats(j_stats)
    err = rel_l1(out.numpy(), np.asarray(ref))
    assert err < (1e-4 if method in ("tsit5", "fixed_adams") else 5e-4)
    if method == "adams":
        from ndcn_tpu_torch.graph.sparse import DenseGraph

        out64, _ = ndcn_forward(model.double(), DenseGraph(
            torch.as_tensor(lap, dtype=torch.float64)), f["t"],
            torch.as_tensor(f["x0"], dtype=torch.float64), **kw)
        assert rel_l1(out.double().numpy(), out64.numpy()) < 1e-5
        with jax.disable_jit():
            eager, _ = j_ndcn_forward(
                jax.tree_util.tree_map(jnp.asarray, tree), j_from_dense(lap),
                jnp.asarray(f["t"]), jnp.asarray(f["x0"]), **kw)
        assert rel_l1(out.numpy(), np.asarray(eager)) < 1e-5


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "adams"])
def test_float64_time_reaches_no_kernel(monkeypatch, method):
    """Under float64 time only the controller's scalars widen: every tensor
    that reaches the kernels' wrappers (K2 here; K1, K3 and K4 take the same
    state) is float32, and the answer is the float32-time one within 1e-5."""
    from ndcn_tpu_torch.models import ndcn as ndcn_module

    seen = []
    plain = ndcn_module.fused_rhs

    def spy(*args):
        seen.extend(a.dtype for a in args if isinstance(a, torch.Tensor))
        return plain(*args)

    monkeypatch.setattr(ndcn_module, "fused_rhs", spy)
    lap = operators.normalized_laplacian(generators.build_network("grid", 25))
    model = ndcn_module.init_ndcn(torch.Generator().manual_seed(0), 1, 6, 1)
    op = from_dense(lap)
    h0 = torch.rand(25, 6, generator=torch.Generator().manual_seed(1))

    def rhs(t, h):
        return ndcn_module.ode_func(model, op, t, h, fused=True)

    t = np.linspace(0.0, 1.0, 5).astype(np.float32)
    with torch.no_grad():
        sols = [odeint_with_stats(rhs, h0, t, rtol=1e-4, atol=1e-6,
                                  method=method,
                                  options=dict(INFER, time_dtype=td))[0]
                for td in ("float64", None)]
    assert seen and set(seen) == {torch.float32}
    assert sols[0].dtype == torch.float32
    assert rel_l1(sols[0].numpy(), sols[1].numpy()) < 1e-5
