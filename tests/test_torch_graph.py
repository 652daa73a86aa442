"""The port's host-side graph code against the JAX package's, bit for bit.

Same seeds in, same arrays out: generators, operators, observation-time
sampling, and the CSR-sorted COO container's triplets.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph import generators as jgen
from ndcn_tpu.graph import operators as jops
from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu.train.sampling import sample_times as j_sample_times
from ndcn_tpu_torch.graph import generators, operators, sparse
from ndcn_tpu_torch.train.sampling import sample_times

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The physics solves below are many small tensor operations: one
    thread runs them faster than a pool that shares the cores with other
    test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _large_graph_example():
    spec = importlib.util.spec_from_file_location(
        "large_graph_example", os.path.join(ROOT, "examples", "large_graph.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [1, 17, 90, 100, 400])
def test_build_network_bit_equal(n):
    ours = generators.build_network("grid", n)
    ref = jgen.build_network("grid", n)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_build_network_grid400_and_unknown_kind():
    assert generators.build_network("grid", 400).shape == (400, 400)
    # the networkx kinds (ROADMAP item 3b) build; small_world has 400 nodes
    for kind in set(generators.NETWORKS) - {"grid"}:
        adj = generators.build_network(kind, 90)
        assert adj.dtype == np.float32 and np.array_equal(adj, adj.T)
        assert adj.shape == ((400, 400) if kind == "small_world"
                             else (90, 90))
    with pytest.raises(ValueError, match="unknown network kind"):
        generators.build_network("lattice", 10)


@pytest.mark.parametrize("side", [20, 11])
def test_grid_block_initial_value_bit_equal(side):
    assert np.array_equal(generators.grid_block_initial_value(side),
                          jgen.grid_block_initial_value(side))


def test_build_sparse_graph_matches_example():
    ours = generators.build_sparse_graph(3000, 10, seed=4)
    ref = _large_graph_example().build_sparse_graph(3000, 10, seed=4)
    assert (ours != ref).nnz == 0 and ours.dtype == ref.dtype


@pytest.mark.parametrize("kind", ["grid", "power_law"])
def test_dense_operators_bit_equal(kind):
    adj = jgen.build_network(kind, 100, seed=1)
    for ours, ref in ((operators.normalized_laplacian, jops.normalized_laplacian),
                      (operators.laplacian_dense, jops.laplacian_dense)):
        a, b = ours(adj), ref(adj)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_normalized_laplacian_sparse_bit_equal():
    adj = generators.build_sparse_graph(2000, 8, seed=2)
    a = operators.normalized_laplacian_sparse(adj)
    b = jops.normalized_laplacian_sparse(adj)
    for field in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("sampled,seed", [("irregular", 0), ("irregular", 7),
                                          ("equal", None)])
def test_sample_times_bit_equal(sampled, seed):
    ours = sample_times(5.0, 40, sampled, seed=seed)
    ref = j_sample_times(5.0, 40, sampled, seed=seed)
    for a, b in zip(ours, ref):
        assert (a is None and b is None) or np.array_equal(a, b)
    with pytest.raises(ValueError, match="unknown sampling"):
        sample_times(5.0, 40, "poisson")


def _power_law(n, m, seed):
    rng = np.random.RandomState(seed)
    rows = rng.zipf(1.5, m) % n
    cols = rng.randint(0, n, m)
    a = sp.coo_matrix((rng.randn(m).astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def test_coo_container_reproduces_jax_triplets():
    a = _power_law(300, 3000, seed=0)
    ours = sparse.from_scipy_coo(a)
    ref = j_from_scipy_coo(a, tiled=False)
    n = a.shape[0]
    assert ours.n == ref.n == n
    for ptr, rows, cols, vals, j_rows, j_cols, j_vals in (
            (ours.row_ptr, ours.rows, ours.cols, ours.vals,
             ref.rows, ref.cols, ref.vals),
            (ours.row_ptr_t, ours.rows_t, ours.cols_t, ours.vals_t,
             ref.rows_t, ref.cols_t, ref.vals_t)):
        assert ptr.dtype == torch.int32 and cols.dtype == torch.int32
        assert np.array_equal(rows.numpy(), np.asarray(j_rows))
        assert np.array_equal(cols.numpy(), np.asarray(j_cols))
        assert np.array_equal(vals.numpy(), np.asarray(j_vals))
        # the CSR pointer expands back to the sorted rows
        expanded = np.repeat(np.arange(n), np.diff(ptr.numpy()))
        assert np.array_equal(expanded, rows.numpy())


def test_as_operator_dense_and_coo():
    adj = jgen.build_network("grid", 64)
    lap = jops.normalized_laplacian(adj)
    dense = sparse.as_operator(lap)
    assert isinstance(dense, sparse.DenseGraph)
    assert np.array_equal(dense.mat.numpy(), np.asarray(j_as_operator(lap).mat))
    coo = sparse.as_operator(sp.csr_matrix(lap), sparse=True)
    assert isinstance(coo, sparse.CooGraph) and coo.n == 64
    x = torch.as_tensor(np.random.RandomState(0).randn(64, 5)
                        .astype(np.float32))
    np.testing.assert_allclose(sparse.matvec(coo, x).numpy(),
                               sparse.matvec(dense, x).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_as_operator_rejects_unported_and_unknown_formats():
    lap = sp.csr_matrix(jops.normalized_laplacian(jgen.build_network("grid", 16)))
    # ELL is ported: the JAX package's packing, slot for slot
    ell = sparse.as_operator(lap, sparse=True, format="ell")
    j_ell = j_as_operator(lap, sparse=True, format="ell")
    assert isinstance(ell, sparse.EllGraph) and ell.cols.shape[1] % 8 == 0
    assert np.array_equal(ell.cols.numpy(), np.asarray(j_ell.cols))
    assert np.array_equal(ell.vals.numpy(), np.asarray(j_ell.vals))
    assert np.array_equal(sparse.to_dense_matrix(ell), lap.toarray())
    # BSR is ported: the same matrix, packed in 128 × 128 blocks
    bsr = sparse.as_operator(lap, sparse=True, format="bsr")
    assert isinstance(bsr, sparse.BsrGraph)
    assert np.array_equal(sparse.to_dense_matrix(bsr), lap.toarray())
    with pytest.raises(ValueError, match="unknown sparse format"):
        sparse.as_operator(lap, sparse=True, format="csc")
    with pytest.raises(ValueError, match="float32"):
        sparse.from_scipy_coo(lap, dtype=torch.float64)


# ------------------------------------------------- the networkx graph zoo

NX_KINDS = ("random", "power_law", "small_world", "community")


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("layout", ["community", "degree"])
@pytest.mark.parametrize("kind", NX_KINDS)
def test_networkx_kinds_bit_equal(kind, layout, seed):
    """Every networkx kind under both node reorderings and two seeds: the
    JAX package's adjacency bit for bit (small_world has 400 nodes
    whatever n is)."""
    ours = generators.build_network(kind, 90, seed=seed, layout=layout)
    ref = jgen.build_network(kind, 90, seed=seed, layout=layout)
    assert ours.dtype == ref.dtype == np.float32
    assert np.array_equal(ours, ref)


def test_node_mapping_and_reordering_match_the_jax_package():
    import networkx as nx

    g = nx.barabasi_albert_graph(50, 3, seed=1)
    for kind in ("degree", "community", None):
        assert generators.generate_node_mapping(g, kind) == \
            jgen.generate_node_mapping(g, kind)
        assert np.array_equal(
            nx.to_numpy_array(generators.reorder_nodes(g, kind)),
            nx.to_numpy_array(jgen.reorder_nodes(g, kind)))


def test_networkx_kinds_name_networkx_when_it_is_missing(monkeypatch):
    """A networkx kind without networkx raises an ImportError that names
    it, and falls back to no other graph; the grid needs no networkx."""
    import sys

    monkeypatch.setitem(sys.modules, "networkx", None)
    for kind in NX_KINDS:
        with pytest.raises(ImportError, match="networkx"):
            generators.build_network(kind, 30)
    assert generators.build_network("grid", 30).shape == (36, 36)


@functools.lru_cache(maxsize=None)
def _ns_graph(net):
    return generators.build_network(net, 400, seed=0)


@pytest.mark.parametrize("net", NX_KINDS)
@pytest.mark.parametrize("dyn", ["heat", "mutualistic", "gene"])
def test_ns_fixtures_through_the_ports_generator(dyn, net):
    """The twelve ``ns_*`` oracle fixtures on the networkx graphs: the
    port's generator reproduces the stored adjacency bit for bit, and the
    physics on it meets the oracle's trajectory within 1e-4 rel-L1 (the
    JAX package's ``tests/test_parity.py`` north-star bar)."""
    from ndcn_tpu_torch.dynamics import make_rhs
    from ndcn_tpu_torch.ode import odeint_with_stats

    f = dict(np.load(os.path.join(ROOT, "tests", "fixtures",
                                  f"ns_{dyn}_{net}.npz")))
    adj = _ns_graph(net)
    assert np.array_equal(adj, f["adj"]), "generator drifted from fixture"
    mat = operators.laplacian_dense(adj) if dyn == "heat" else adj
    with torch.no_grad():
        sol, stats = odeint_with_stats(
            make_rhs(dyn, sparse.as_operator(mat)), torch.as_tensor(f["x0"]),
            f["t"], rtol=1e-7, atol=1e-9, method="dopri5",
            options={"differentiable": False})
    assert stats.success
    err = float(np.abs(sol.numpy() - f["sol"]).mean()
                / np.abs(f["sol"]).mean())
    assert err < 1e-4
