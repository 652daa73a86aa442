"""The port's Planetoid loader and the classification operators against the
JAX package's: every array equal (``np.array_equal``), the scipy operators
bit-equal on random graphs."""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp

from ndcn_tpu.data import load_planetoid as j_load_planetoid
from ndcn_tpu.graph import operators as j_ops
from ndcn_tpu_torch.data import load_planetoid
from ndcn_tpu_torch.graph import operators

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(ROOT, "data")
FIELDS = ("features", "labels", "idx_train", "idx_val", "idx_test")


def _csr_equal(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def _assert_same(got, ref):
    assert _csr_equal(got.operator, ref.operator)
    assert _csr_equal(got.adjacency, ref.adjacency)
    for name in FIELDS:
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == r.dtype and np.array_equal(g, r), name


@pytest.mark.parametrize("name", ["cora", "citeseer"])
@pytest.mark.parametrize("alpha", [0.5, 0.0])
def test_planetoid_equals_jax(name, alpha):
    got = load_planetoid(name, alpha=alpha, data_dir=DATA_DIR)
    _assert_same(got, j_load_planetoid(name, alpha=alpha, data_dir=DATA_DIR))
    n = {"cora": 2708, "citeseer": 3327}[name]
    assert got.features.shape[0] == got.operator.shape[0] == n


def test_synthetic_planetoid_round_trips(tmp_path):
    sys.path.insert(0, ROOT)
    from tools.make_synthetic_planetoid import make_dataset

    make_dataset("torch_synth", n=300, n_features=64, n_classes=5,
                 out_dir=str(tmp_path), seed=0, n_test=50)
    got = load_planetoid("torch_synth", alpha=0.5, data_dir=str(tmp_path))
    _assert_same(got, j_load_planetoid("torch_synth", alpha=0.5,
                                       data_dir=str(tmp_path)))
    assert got.features.shape == (300, 64) and len(got.idx_test) == 50
    assert int(got.labels.max()) + 1 == 5


def test_pubmed_raises_naming_allx():
    with pytest.raises(FileNotFoundError, match="allx"):
        load_planetoid("pubmed", data_dir=DATA_DIR)


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        load_planetoid("no_such_graph", data_dir=DATA_DIR)


def _random_graph(seed, n=60, p=0.1, loops=False):
    rng = np.random.RandomState(seed)
    a = (rng.rand(n, n) < p).astype(np.float64)
    a = np.maximum(a, a.T)
    if not loops:
        np.fill_diagonal(a, 0.0)
    a[3, :] = a[:, 3] = 0.0          # an isolated node: the zero guards
    return sp.csr_matrix(a)


SPARSE_BUILDERS = ["row_normalization", "random_walk", "laplacian",
                   "normalized_laplacian_sparse", "zipf_smoothing_sparse",
                   "zipf_smoothing_prime", "first_order_gcn"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", SPARSE_BUILDERS)
def test_sparse_operators_bit_equal_jax(fn, seed):
    a = _random_graph(seed)
    assert _csr_equal(getattr(operators, fn)(a), getattr(j_ops, fn)(a))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
def test_zipf_smoothing_alpha_bit_equal_jax(alpha):
    a = _random_graph(2)
    assert _csr_equal(operators.zipf_smoothing_alpha(a, alpha),
                      j_ops.zipf_smoothing_alpha(a, alpha))


@pytest.mark.parametrize("delta", [0.5, 2.0])
def test_residual_smoothing_bit_equal_jax(delta):
    a = _random_graph(3)
    assert _csr_equal(operators.residual_smoothing(a, delta),
                      j_ops.residual_smoothing(a, delta))


def test_helpers_and_dense_builders_bit_equal_jax():
    a = _random_graph(4, loops=True)
    assert operators.number_of_self_loops(a) == j_ops.number_of_self_loops(a)
    for got, ref in zip(operators._degrees(a), j_ops._degrees(a)):
        assert np.array_equal(got, ref)
    out, inn = j_ops._degrees(a)
    assert _csr_equal(operators._sym_norm_sparse(a, out, inn),
                      j_ops._sym_norm_sparse(a, out, inn))
    dense = np.asarray(_random_graph(5).todense())
    assert np.array_equal(operators.normalized_plus(dense),
                          j_ops.normalized_plus(dense))
    for fn in ("zipf_smoothing_sparse", "residual_smoothing"):
        with pytest.raises(ValueError, match="self-loops"):
            getattr(operators, fn)(a, *([1.0] if "residual" in fn else []))
