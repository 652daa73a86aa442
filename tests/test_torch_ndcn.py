"""The serving slice end to end: NDCN, the converter and the server, against
the JAX package and the oracle fixture.

Weights cross through ``convert.params_from_jax``; inputs come from numpy
seeds. Bars: 1e-4 rel-L1 against the ``ndcn_forward_grid400`` oracle and
against JAX's ``ndcn_forward(nondiff=True)`` (same NFE), and against JAX's
``load_ndcn(export_ndcn(...))`` server (same success flag).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.graph.sparse import from_dense as j_from_dense
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.serve import export_ndcn, load_ndcn
from ndcn_tpu_torch.convert import params_from_jax, params_to_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_dense
from ndcn_tpu_torch.models import NDCN, init_ndcn, ndcn_forward
from ndcn_tpu_torch.serve import make_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
KW = dict(rtol=0.01, atol=0.001, method="dopri5")


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _grid400():
    f = dict(np.load(os.path.join(FIX, "ndcn_forward_grid400.npz")))
    tree = {name: {"w": f[f"{name}_w"].T, "b": f[f"{name}_b"]}
            for name in ("enc1", "enc2", "wt", "dec")}
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    return f, tree, lap


def _jax_params(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_params_from_jax_round_trip_and_layouts():
    _, tree, _ = _grid400()
    model = params_from_jax(tree)
    assert model.enc1.weight.shape == (20, 1) and model.dec.weight.shape == (1, 20)
    assert np.array_equal(model.wt.weight.detach().numpy(), tree["wt"]["w"].T)
    back = params_to_jax(model)
    assert set(back) == set(tree)
    for name in tree:
        for leaf in ("w", "b"):
            assert np.array_equal(back[name][leaf], tree[name][leaf])
    # loading into an existing model of the same shape
    other = init_ndcn(torch.Generator().manual_seed(5), 1, 20, 1)
    assert params_from_jax(tree, model=other) is other
    assert np.array_equal(other.enc2.bias.detach().numpy(), tree["enc2"]["b"])
    with pytest.raises(ValueError, match="layer sets differ"):
        params_from_jax({k: v for k, v in tree.items() if k != "wt"},
                        model=other)
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax(tree, model=init_ndcn(torch.Generator(), 1, 8, 1))


def test_params_from_jax_matches_jax_init_tree():
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init_ndcn(jax.random.PRNGKey(2), 3, 16, 2))
    model = params_from_jax(tree)
    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    h_t = torch.tanh(torch.as_tensor(x) @ model.enc1.weight.T + model.enc1.bias)
    h_j = np.tanh(x @ tree["enc1"]["w"] + tree["enc1"]["b"])
    np.testing.assert_allclose(h_t.detach().numpy(), h_j, rtol=1e-6, atol=1e-6)


def test_init_ndcn_draws_from_the_generator():
    a = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1)
    b = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1)
    c = init_ndcn(torch.Generator().manual_seed(1), 1, 20, 1)
    for (_, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                         b.named_parameters(),
                                         c.named_parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    bound = 1.0 / np.sqrt(20)
    assert float(a.wt.weight.detach().abs().max()) <= bound
    assert float(a.enc1.weight.detach().abs().max()) <= 1.0      # fan_in 1
    flags = init_ndcn(torch.Generator(), 3, 8, 2, no_embed=True,
                      no_control=True)
    assert flags.enc1 is None and flags.wt is None
    assert flags.dec.weight.shape == (2, 3)
    assert isinstance(flags, NDCN)


@pytest.mark.parametrize("fused", [False, "auto", True])
def test_ndcn_forward_grid400_vs_oracle_and_jax(fused):
    f, tree, lap = _grid400()
    model = params_from_jax(tree)
    out, stats = ndcn_forward(model, from_dense(lap), f["t"],
                              torch.as_tensor(f["x0"]), nondiff=True,
                              fused=fused, **KW)
    assert stats.success and out.shape == f["out"].shape
    assert rel_l1(out.numpy(), f["out"]) < 1e-4
    # the JAX package at fused=False: "auto" and True route its dense RHS
    # through the Pallas kernel, whose interpret mode the kernel tests cover
    ref, j_stats = j_ndcn_forward(_jax_params(tree), j_from_dense(lap),
                                  jnp.asarray(f["t"]), jnp.asarray(f["x0"]),
                                  nondiff=True, **KW)
    assert rel_l1(out.numpy(), ref) < 1e-4
    assert (stats.nfe, stats.n_accepted, stats.n_rejected) == (
        int(j_stats.nfe), int(j_stats.n_accepted), int(j_stats.n_rejected))


def test_ndcn_forward_fused_auto_matches_jax_fused_auto():
    f, tree, lap = _grid400()
    t = f["t"][:6]
    out, stats = ndcn_forward(params_from_jax(tree), from_dense(lap), t,
                              torch.as_tensor(f["x0"]), nondiff=True,
                              fused="auto", **KW)
    ref, j_stats = j_ndcn_forward(_jax_params(tree), j_from_dense(lap),
                                  jnp.asarray(t), jnp.asarray(f["x0"]),
                                  nondiff=True, fused="auto", **KW)
    assert rel_l1(out.numpy(), ref) < 1e-4
    assert stats.nfe == int(j_stats.nfe)


def _small_coo(seed=0):
    adj = generators.build_sparse_graph(2000, 10, seed=seed)
    return operators.normalized_laplacian_sparse(adj)


def test_ndcn_forward_coo_2k_vs_jax():
    lap = _small_coo()
    j_params = j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    t = np.linspace(0.0, 2.0, 12).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (2000, 1)).astype(np.float32)
    out, stats = ndcn_forward(model, as_operator(lap, sparse=True), t,
                              torch.as_tensor(x0), nondiff=True,
                              fused="auto", **KW)
    ref, j_stats = j_ndcn_forward(j_params, j_as_operator(lap, sparse=True),
                                  jnp.asarray(t), jnp.asarray(x0),
                                  nondiff=True, fused="auto", **KW)
    assert stats.success and bool(j_stats.success)
    assert rel_l1(out.numpy(), ref) < 1e-4
    assert stats.nfe == int(j_stats.nfe)


@pytest.mark.parametrize("fmt", ["dense", "coo"])
def test_make_server_vs_jax_export(fmt):
    lap = operators.normalized_laplacian(generators.build_network("grid", 100))
    j_params = j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    sparse = fmt == "coo"
    mat = sp.csr_matrix(lap) if sparse else lap
    vt = np.linspace(0.0, 1.0, 8).astype(np.float32)
    x = np.random.RandomState(1).rand(100, 1).astype(np.float32)
    # nondiff / adjoint from a training config are dropped, as export_ndcn does
    server = make_server(model, as_operator(mat, sparse=sparse), vt,
                         nondiff=False, adjoint=True, **KW)
    out, ok = server(x)
    blob = export_ndcn(j_params, j_as_operator(mat, sparse=sparse),
                       jnp.asarray(vt), x.shape, **KW)
    ref, j_ok = load_ndcn(blob)(jnp.asarray(x))
    assert ok is True and bool(j_ok)
    assert rel_l1(out.numpy(), ref) < 1e-4
    assert server.last_stats.host_syncs == (server.last_stats.n_accepted
                                            + server.last_stats.n_rejected)


def test_make_server_terminal_and_budget():
    lap = operators.normalized_laplacian(generators.build_network("grid", 64))
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 8, 3)
    vt = np.linspace(0.0, 1.0, 5)
    x = np.random.RandomState(2).rand(64, 1)
    out, ok = make_server(model, from_dense(lap), vt, terminal=True, **KW)(x)
    assert ok and out.shape == (64, 3)
    # an exhausted step budget is reported, not hidden
    _, ok = make_server(model, from_dense(lap), vt, rtol=1e-9, atol=1e-12,
                        max_steps=2)(x)
    assert ok is False


@pytest.mark.parametrize("kwargs,err,match", [
    # the fused kernels need a fusable RHS, with the adjoint too
    (dict(nondiff=False, no_control=True, fused=True, adjoint=True),
     ValueError, "fused=True requires"),
    (dict(nondiff=True, no_graph=True, fused=True), ValueError,
     "fused=True requires"),
    # a dense operator on the CPU does not serve the feature-major solve
    (dict(nondiff=True, layout="feature_major"), ValueError, "feature_major"),
    (dict(nondiff=True, layout="nm"), ValueError, "unknown layout"),
    (dict(nondiff=True, fused="yes"), ValueError, "fused must be"),
])
def test_ndcn_forward_refuses_unported_options(kwargs, err, match):
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 4, 1)
    lap = operators.normalized_laplacian(generators.build_network("grid", 16))
    with pytest.raises(err, match=match):
        ndcn_forward(model, from_dense(lap), [0.0, 0.5], torch.ones(16, 1),
                     **kwargs)


@pytest.mark.parametrize("kwargs,changes", [
    (dict(nondiff=False, emission_dtype=torch.bfloat16), True),
    (dict(nondiff=True, layout="feature_major"), True),
    # the inference solve takes no emission options (the JAX package's
    # ode_block strips them there): the answer is the f32 one, bit for bit
    (dict(nondiff=True, emission_dtype=torch.bfloat16), False),
    (dict(nondiff=True, residual_dtype=torch.bfloat16), True),
])
def test_ndcn_forward_scale_options_run(kwargs, changes, monkeypatch):
    """The options the serving and training slices refused ("item 4") run, on a COO
    operator that serves the SpMV kernels, close to the plain (n, d) f32
    solve."""
    from ndcn_tpu_torch.graph import sparse as graph_sparse

    monkeypatch.setattr(graph_sparse, "use_tiled_kernel", lambda op: True)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 12, 1)
    lap = operators.normalized_laplacian(generators.build_network("grid", 64))
    op = as_operator(sp.csr_matrix(lap), sparse=True)
    vt = np.linspace(0.0, 1.0, 6)
    x = torch.as_tensor(np.random.RandomState(3).rand(64, 1).astype(np.float32))
    ref, ref_stats = ndcn_forward(model, op, vt, x,
                                  nondiff=kwargs["nondiff"], **KW)
    out, stats = ndcn_forward(model, op, vt, x, **kwargs, **KW)
    assert stats.success and out.shape == ref.shape == (6, 64, 1)
    err = rel_l1(out.detach().numpy(), ref.detach().numpy())
    assert err <= 1e-2
    assert (err > 0) == changes


def test_fused_true_requires_a_fusable_configuration():
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 4, 1)
    lap = operators.normalized_laplacian(generators.build_network("grid", 16))
    coo = as_operator(sp.csr_matrix(lap), sparse=True)
    x = torch.ones(16, 1)
    with pytest.raises(ValueError, match="fused=True requires a dense or BSR"):
        ndcn_forward(model, coo, [0.0, 0.5], x, nondiff=True, fused=True)
    with pytest.raises(ValueError, match="fused=True requires a dense or BSR"):
        ndcn_forward(model, from_dense(lap), [0.0, 0.5], x, nondiff=True,
                     fused=True, no_graph=True)
    # "auto" takes the standard path where it cannot fuse
    out, stats = ndcn_forward(model, coo, [0.0, 0.5], x, nondiff=True,
                              fused="auto")
    assert stats.success and out.shape == (2, 16, 1)


@pytest.mark.parametrize("fmt", ["dense", "coo", "bsr"])
def test_ndcn_forward_differentiable_matches_inference_and_jax(fmt):
    """nondiff=False (the training path) gives the inference forward's
    answer and NFE, and the JAX package's differentiable forward."""
    lap = operators.normalized_laplacian(generators.build_network("grid", 100))
    j_params = j_init_ndcn(jax.random.PRNGKey(3), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    op = as_operator(mat, sparse=fmt != "dense", format=fmt)
    vt = np.linspace(0.0, 1.0, 6).astype(np.float32)
    x = torch.as_tensor(np.random.RandomState(4).rand(100, 1)
                        .astype(np.float32))
    out, stats = ndcn_forward(model, op, vt, x, **KW)
    inf, inf_stats = ndcn_forward(model, op, vt, x, nondiff=True, **KW)
    assert out.requires_grad and not inf.requires_grad
    assert torch.equal(out.detach(), inf) and stats.nfe == inf_stats.nfe
    ref, j_stats = j_ndcn_forward(j_params, j_as_operator(
        mat, sparse=fmt != "dense", format=fmt), jnp.asarray(vt),
        jnp.asarray(x.numpy()), max_steps=256, **KW)
    assert rel_l1(out.detach().numpy(), ref) < 1e-4
    assert stats.nfe == int(j_stats.nfe)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "ndcn_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ndcn_tpu", "flax", "optax"), \
                f"{path} imports {mod}"
