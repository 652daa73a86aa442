"""The serving artifact: ``serve.export_ndcn`` / ``load_ndcn``, the drivers'
``--export`` and the device-resident solves under them
(``ode.adaptive.solve_while``, ``ode.vcabm.solve_vcabm_while``), against
the JAX package's artifact, the port's in-process server and the host-loop
solves.

Weights cross through ``convert.params_from_jax``; inputs come from numpy
seeds. Bars: ``solve_while`` bit-equal to ``solve`` with equal NFE and
step counts (the same operations in the same order); ``solve_vcabm_while``
within 1e-5 rel-L1 of ``solve_vcabm`` with equal NFE (its masked sums
round apart); the artifact 1e-4 rel-L1 of JAX's
``load_ndcn(export_ndcn(...))`` (the bound of ``tests/test_torch_ndcn.py``)
and 1e-6 max|Δ| of the port's ``Server`` (the adams artifact 1e-5
rel-L1), both ``success`` true. Each ``torch.export`` takes seconds, so
the file makes twelve.
"""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.graph.sparse import from_dense as j_from_dense
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.serve import export_ndcn as j_export_ndcn
from ndcn_tpu.serve import load_ndcn as j_load_ndcn
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_dense
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import adaptive, vcabm
from ndcn_tpu_torch.ode.step_control import Controller
from ndcn_tpu_torch.serve import (export_ndcn, load_artifact, load_ndcn,
                                  make_server, save_artifact)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(rtol=0.01, atol=0.001, method="dopri5")
# the kernels' operator in each format's artifact
FORMATS = {"dense": ("auto", "ndcn_tpu_torch.fused_rhs"),
           "coo": (False, "ndcn_tpu_torch.coo_spmv"),
           "bsr": (False, "ndcn_tpu_torch.bsr_spmm")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small solves: one intra-op thread, as tests/test_torch_dynamics.py
    pins it, so that the tier-1 run's workers do not contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _problem():
    lap = operators.normalized_laplacian(generators.build_network("grid", 100))
    j_params = j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    vt = np.linspace(0.0, 1.0, 8).astype(np.float32)
    x = np.random.RandomState(1).rand(100, 1).astype(np.float32)
    return lap, j_params, model, vt, x


def _operators(lap, fmt):
    if fmt == "dense":
        return from_dense(lap), j_from_dense(lap)
    mat = sp.csr_matrix(lap)
    return (as_operator(mat, sparse=True, format=fmt),
            j_as_operator(mat, sparse=True, format=fmt))


def _kernel_ops(blob) -> set:
    """The port's operators the artifact's graphs call."""
    program = torch.export.load(io.BytesIO(blob))
    return {str(node.target).rsplit(".", 1)[0]
            for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes
            if node.op == "call_function"
            and str(node.target).startswith("ndcn_tpu_torch.")}


@pytest.fixture(scope="module")
def artifacts():
    """The port's artifact of the 100-node grid problem in each format."""
    lap, _, model, vt, x = _problem()
    return {fmt: export_ndcn(model, _operators(lap, fmt)[0], vt, x.shape,
                             fused=fused, **KW)
            for fmt, (fused, _) in FORMATS.items()}


# ------------------------------------------------------------ solve_while


def _grid400_rhs(seed=0):
    """The NDCN right-hand side at ndcn_forward_grid400's size: the 400-node
    grid's normalized Laplacian, hidden 20, weights from a numpy seed."""
    rs = np.random.RandomState(seed)
    lap = torch.as_tensor(operators.normalized_laplacian(
        generators.build_network("grid", 400)), dtype=torch.float32)
    w = torch.as_tensor((rs.randn(20, 20) / np.sqrt(20)).astype(np.float32))
    b = torch.as_tensor((rs.randn(20) * 0.1).astype(np.float32))
    h0 = torch.as_tensor(rs.uniform(-1, 1, (400, 20)).astype(np.float32))
    return (lambda t, h: torch.relu((lap @ h) @ w + b)), h0


def _both(method, func, y0, t, max_steps=1 << 16):
    ctrl = Controller(rtol=0.01, atol=0.001)
    with torch.no_grad():
        return (adaptive.solve(method, func, y0, t, ctrl, max_steps),
                adaptive.solve_while(method, func, y0, t, ctrl, max_steps))


def _assert_same(ref, got):
    (a, sa), (b, sb) = ref, got
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert (sa.nfe, sa.n_accepted, sa.n_rejected, sa.success) == (
        int(sb.nfe), int(sb.n_accepted), int(sb.n_rejected), bool(sb.success))


@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["dopri5", "tsit5"])
def test_solve_while_repeats_solve(name, tdtype):
    """The device-resident loop runs the host loop's operations in its
    order: bit-equal observations, equal NFE and step counts."""
    method = {"dopri5": adaptive.DOPRI5_METHOD,
              "tsit5": adaptive.TSIT5_METHOD}[name]
    func, h0 = _grid400_rhs()
    t = torch.as_tensor(np.sort(np.random.RandomState(2).uniform(0, 5, 12)),
                        dtype=tdtype)
    t = torch.cat([torch.zeros(1, dtype=tdtype), t])
    ref, got = _both(method, func, h0, t)
    assert ref[1].success and ref[1].n_accepted > 3
    _assert_same(ref, got)
    assert got[1].host_syncs is None


@pytest.mark.parametrize("tdtype", [torch.float32, torch.float64])
def test_solve_vcabm_while_repeats_solve_vcabm(tdtype):
    """The masked VCABM machine in one ``while_loop`` against the host
    loop's ``solve_vcabm``: equal NFE and step counts, observations within
    1e-5 rel-L1 (the masked sums may round differently)."""
    func, h0 = _grid400_rhs()
    t = torch.as_tensor(np.sort(np.random.RandomState(2).uniform(0, 5, 12)),
                        dtype=tdtype)
    t = torch.cat([torch.zeros(1, dtype=tdtype), t])
    with torch.no_grad():
        a, sa = vcabm.solve_vcabm(func, h0, t, 0.01, 0.001)
        b, sb = vcabm.solve_vcabm_while(func, h0, t, 0.01, 0.001)
    assert sa.success and sa.n_accepted > 10
    assert (sa.nfe, sa.n_accepted, sa.n_rejected, sa.success) == (
        int(sb.nfe), int(sb.n_accepted), int(sb.n_rejected), bool(sb.success))
    assert rel_l1(b.numpy(), a.numpy()) <= 1e-5
    # a blown budget: the same rows reached, the rest NaN
    with torch.no_grad():
        a, sa = vcabm.solve_vcabm(func, h0, t, 0.01, 0.001, max_steps=6)
        b, sb = vcabm.solve_vcabm_while(func, h0, t, 0.01, 0.001,
                                        max_steps=6)
    assert not sa.success and not bool(sb.success)
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert (sa.nfe, sa.n_accepted) == (int(sb.nfe), int(sb.n_accepted))


def test_solve_while_stops_as_solve_does():
    """A blown budget and a dt underflow end the loop where ``solve``
    ends: success false, the same rows reached, the rest NaN."""
    func, h0 = _grid400_rhs()
    t = torch.linspace(0.0, 5.0, 9)
    ref, got = _both(adaptive.DOPRI5_METHOD, func, h0, t, max_steps=3)
    assert not ref[1].success and torch.isnan(ref[0][-1]).all()
    _assert_same(ref, got)
    # y' = y² blows up at t = 1 / y0: non-finite attempts shrink dt until
    # t1 + dt == t1 in float32
    y0 = torch.ones(400, 20) * torch.linspace(0.9, 1.0, 20)
    ref, got = _both(adaptive.DOPRI5_METHOD, lambda t, y: y * y, y0,
                     torch.tensor([0.0, 0.5, 1.5, 2.0]))
    assert not ref[1].success and ref[1].n_rejected > 10
    assert ref[1].n_accepted + ref[1].n_rejected < 1 << 16
    _assert_same(ref, got)


# --------------------------------------------------------------- artifacts


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_artifact_matches_jax_artifact_and_server(fmt, artifacts):
    lap, j_params, model, vt, x = _problem()
    op, j_op = _operators(lap, fmt)
    fused, kernel = FORMATS[fmt]
    blob = artifacts[fmt]
    assert _kernel_ops(blob) == {kernel}
    out, ok = load_ndcn(blob)(x)
    ref, j_ok = j_load_ndcn(j_export_ndcn(j_params, j_op, jnp.asarray(vt),
                                          x.shape, **KW))(jnp.asarray(x))
    assert bool(ok) and bool(j_ok)
    assert out.shape == (8, 100, 1)
    assert rel_l1(out.numpy(), ref) < 1e-4
    server = make_server(model, op, vt, fused=fused, **KW)
    s_out, s_ok = server(x)
    assert s_ok is True
    assert float((out - s_out).abs().max()) <= 1e-6


def test_terminal_classifier_drops_training_switches(tmp_path):
    """The dgnn serving shape (terminal state → logits) on BSR through K4,
    with a training config's nondiff=False / adjoint=True dropped."""
    lap, _, model, vt, x = _problem()
    op = _operators(lap, "bsr")[0]
    kw = dict(terminal=True, rtol=0.1, atol=0.1, method="dopri5",
              fused="auto")
    blob = export_ndcn(model, op, vt, x.shape, nondiff=False, adjoint=True,
                       **kw)
    assert _kernel_ops(blob) == {"ndcn_tpu_torch.bsr_fused_rhs"}
    path = str(tmp_path / "model.pt2")
    save_artifact(path, blob)
    out, ok = load_ndcn(load_artifact(path))(x)
    ref, stats = ndcn_forward(model, op, vt, torch.as_tensor(x),
                              nondiff=True, **kw)
    assert out.shape == (100, 1) and bool(ok) and stats.success
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.fixture(scope="module")
def feature_major_artifact():
    """The port's artifact of the 100-node grid problem on COO with
    ``layout="auto"`` where 'auto' picks the feature-major solve (the
    threshold lowered to 50 nodes, the SpMV kernels' seam on): K1-fm's
    pack and gather. The same program as ``layout="feature_major"``
    exports (``test_feature_major_artifact_matches_jax_artifact_and_server``
    serves it), traced once."""
    from ndcn_tpu_torch.graph import sparse as graph_sparse
    from ndcn_tpu_torch.models import ndcn as ndcn_mod

    lap, _, model, vt, x = _problem()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
        mp.setattr(ndcn_mod, "_FEATURE_MAJOR_AUTO_NODES", 50)
        op = _operators(lap, "coo")[0]
        assert ndcn_mod.resolve_layout("auto", op, torch.zeros(
            (100, 20))) == "feature_major"
        return export_ndcn(model, op, vt, x.shape, **KW)


def test_export_refuses_adams_and_feature_major(monkeypatch,
                                                adams_artifacts,
                                                feature_major_artifact):
    """The Adams methods and the feature-major layout that 'auto' picks
    from 500k nodes on a COO operator were refused until ROADMAP §1 entry
    11b′ was ported; they export now. The adams artifact, the masked VCABM
    machine in a ``while_loop``, serves the ``Server``'s host-indexed
    solve within 1e-5 rel-L1; the 'auto' feature-major artifact holds K1-fm's
    pack and gather and serves the ``Server``'s answer within 1e-6."""
    lap, _, model, vt, x = _problem()
    out, ok = load_ndcn(adams_artifacts["adams"])(x)
    server = make_server(model, from_dense(lap), vt, fused="auto",
                         **dict(KW, method="adams"))
    s_out, s_ok = server(x)
    assert bool(ok) and s_ok and rel_l1(out.numpy(), s_out.numpy()) <= 1e-5
    from ndcn_tpu_torch.graph import sparse as graph_sparse
    from ndcn_tpu_torch.models import ndcn as ndcn_mod
    monkeypatch.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
    monkeypatch.setattr(ndcn_mod, "_FEATURE_MAJOR_AUTO_NODES", 50)
    op = _operators(lap, "coo")[0]
    blob = feature_major_artifact
    assert _kernel_ops(blob) == {"ndcn_tpu_torch.pack_rows",
                                 "ndcn_tpu_torch.gather_T"}
    out, ok = load_ndcn(blob)(x)
    s_out, s_ok = make_server(model, op, vt, **KW)(x)
    assert bool(ok) and s_ok
    assert float((out - s_out).abs().max()) <= 1e-6


ADAMS = ("adams", "fixed_adams", "explicit_adams")


@pytest.fixture(scope="module")
def adams_artifacts():
    """The port's artifact of the 100-node grid problem (dense, K2) with
    each Adams method."""
    lap, _, model, vt, x = _problem()
    return {m: export_ndcn(model, from_dense(lap), vt, x.shape, fused="auto",
                           **dict(KW, method=m)) for m in ADAMS}


@pytest.mark.parametrize("method", ADAMS)
def test_adams_artifact_matches_jax_artifact_and_server(method,
                                                        adams_artifacts):
    """The Adams artifacts (ROADMAP §1 entry 11b′) against JAX's artifact
    (1e-4 rel-L1) and the port's ``Server``: the fixed-grid methods unroll
    the ``Server``'s operations (1e-6 max|Δ|); adams runs the masked
    machine against the host-indexed solve (1e-5 rel-L1)."""
    lap, j_params, model, vt, x = _problem()
    kw = dict(KW, method=method)
    blob = adams_artifacts[method]
    assert _kernel_ops(blob) == {"ndcn_tpu_torch.fused_rhs"}
    out, ok = load_ndcn(blob)(x)
    ref, j_ok = j_load_ndcn(j_export_ndcn(j_params, j_from_dense(lap),
                                          jnp.asarray(vt), x.shape, **kw))(
        jnp.asarray(x))
    assert bool(ok) and bool(j_ok) and out.shape == (8, 100, 1)
    assert rel_l1(out.numpy(), ref) < 1e-4
    s_out, s_ok = make_server(model, from_dense(lap), vt, fused="auto",
                              **kw)(x)
    assert s_ok
    if method == "adams":
        assert rel_l1(out.numpy(), s_out.numpy()) <= 1e-5
    else:
        assert float((out - s_out).abs().max()) <= 1e-6


@pytest.mark.parametrize("wide", [False, True])
def test_feature_major_artifact_matches_jax_artifact_and_server(
        wide, monkeypatch, feature_major_artifact):
    """``layout="feature_major"`` exported (ROADMAP §1 entry 11b′): K1-fm's
    pack and gather, or K5's gather under ``GATHER_WIDE``, as operators of
    the program; against JAX's feature-major artifact (its Pallas
    ``spmv_T`` in interpret mode; 1e-4 rel-L1) and the port's ``Server``
    (1e-6 max|Δ|)."""
    from ndcn_tpu.graph import sparse as j_gs
    from ndcn_tpu.kernels import coo_spmv as j_ck
    from ndcn_tpu_torch.graph import sparse as graph_sparse
    from ndcn_tpu_torch.kernels import coo_spmv as ck
    monkeypatch.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
    monkeypatch.setattr(j_gs, "use_tiled_kernel", lambda: True)
    monkeypatch.setattr(ck, "GATHER_WIDE", wide)
    monkeypatch.setattr(j_ck, "GATHER_WIDE", wide)
    lap, j_params, model, vt, x = _problem()
    mat = sp.csr_matrix(lap)
    kw = dict(KW, layout="feature_major")
    op = graph_sparse.from_scipy_coo(mat)
    # K1-fm's program is the 'auto' artifact's (traced once, the fixture)
    blob = (export_ndcn(model, op, vt, x.shape, **kw) if wide
            else feature_major_artifact)
    assert _kernel_ops(blob) == (
        {"ndcn_tpu_torch.gather_T_wide"} if wide else
        {"ndcn_tpu_torch.pack_rows", "ndcn_tpu_torch.gather_T"})
    out, ok = load_ndcn(blob)(x)
    ref, j_ok = j_load_ndcn(j_export_ndcn(
        j_params, j_gs.from_scipy_coo(mat, tiled=True), jnp.asarray(vt),
        x.shape, **kw))(jnp.asarray(x))
    assert bool(ok) and bool(j_ok)
    assert rel_l1(out.numpy(), ref) < 1e-4
    s_out, s_ok = make_server(model, op, vt, **kw)(x)
    assert s_ok and float((out - s_out).abs().max()) <= 1e-6


def test_dynamics_driver_export(tmp_path):
    """--export on the heat driver: the artifact predicts the trajectory
    over the run's full observation grid from x0 alone."""
    from ndcn_tpu_torch.experiments import dynamics

    path = str(tmp_path / "heat.pt2")
    res = dynamics.run("heat", dynamics.build_parser("heat").parse_args(
        ["--network", "grid", "--n", "100", "--time_tick", "20",
         "--niters", "10", "--test_freq", "5", "--method", "dopri5",
         "--seed", "0", "--export", path, "--platform", "cpu"]))
    assert res["export"] == path
    out, ok = load_ndcn(load_artifact(path))(
        np.zeros((100, 1), np.float32) + 5.0)
    assert bool(ok)
    # irregular sampling draws 1.2x time_tick observation times
    assert out.shape == (24, 100, 1) and torch.isfinite(out).all()


def test_dgnn_driver_export(tmp_path):
    """--export on the dgnn driver: the loaded artifact's logits give the
    trained model's test accuracy."""
    from ndcn_tpu_torch.data import load_planetoid
    from ndcn_tpu_torch.experiments import dgnn

    path = str(tmp_path / "cora.pt2")
    summary = dgnn.main(["--dataset", "cora", "--model", "differential_gcn",
                         "--epochs", "3", "--hidden", "16", "--T", "1.2",
                         "--time_tick", "4", "--dropout", "0",
                         "--no_control", "--seed", "0", "--export", path,
                         "--platform", "cpu",
                         "--data_dir", os.path.join(ROOT, "data")])
    assert summary["export"] == path
    data = load_planetoid("cora", alpha=0.5,
                          data_dir=os.path.join(ROOT, "data"))
    logits, ok = load_ndcn(load_artifact(path))(data.features)
    assert bool(ok) and logits.shape == (2708, 7)
    pred = logits.argmax(1).numpy()[data.idx_test]
    acc = float((pred == data.labels[data.idx_test]).mean())
    assert abs(acc - summary["rows"][-1][2]) < 0.01


def test_artifact_serves_without_the_model_code(tmp_path, artifacts):
    """A fresh process that imports torch and ``ndcn_tpu_torch.kernels``
    only (for the kernels' operators) loads the artifact and serves the
    in-process answer; jax and the port's models, solvers, graphs and
    serving module stay out of it."""
    lap, _, model, vt, x = _problem()
    path = str(tmp_path / "m.pt2")
    save_artifact(path, artifacts["coo"])
    ref, _ = make_server(model, _operators(lap, "coo")[0], vt, **KW)(x)
    np.save(str(tmp_path / "x.npy"), x)
    np.save(str(tmp_path / "ref.npy"), ref.numpy())
    code = f"""
import sys
import numpy as np
import torch
import ndcn_tpu_torch.kernels
program = torch.export.load({path!r}).module()
out, ok = program(torch.as_tensor(np.load({str(tmp_path / 'x.npy')!r})))
assert bool(ok)
ref = np.load({str(tmp_path / 'ref.npy')!r})
assert float(np.abs(out.numpy() - ref).max()) <= 1e-6
for name in ("jax", "ndcn_tpu", "ndcn_tpu_torch.models", "ndcn_tpu_torch.ode",
             "ndcn_tpu_torch.graph", "ndcn_tpu_torch.serve"):
    assert name not in sys.modules, name
print("SERVED-WITHOUT-THE-MODEL-CODE")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SERVED-WITHOUT-THE-MODEL-CODE" in r.stdout
