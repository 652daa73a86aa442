"""Planetoid citation networks (cora / citeseer / pubmed), as
``ndcn_tpu/data/planetoid.py`` (the reference's ``utils.py:91-230``).

The ``ind.*`` pickles; citeseer's isolated test nodes widened to the full
test-index range with zero rows; features and labels reordered by the test
index; the directed citations symmetrised into a 0/1 adjacency; the
standard splits (train = the first len(y) labelled nodes, val = the next
500, test = the test-index file); row-normalised features; and the
propagation operator ``zipf_smoothing_alpha(adj, alpha)``. The tests hold
every array equal to the JAX package's.

The arrays come back as host numpy / scipy: the caller builds the device
operator (dense, COO, ELL or BSR) and places the features.

``data/pubmed`` lacks ``ind.pubmed.allx`` (absent upstream), so pubmed raises
``FileNotFoundError`` until that file is supplied.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp

from ndcn_tpu_torch.graph.operators import (row_normalization,
                                            zipf_smoothing_alpha)

DATASETS = ("cora", "citeseer", "pubmed")
_PARTS = ("x", "y", "tx", "ty", "allx", "ally", "graph")


class Planetoid(NamedTuple):
    operator: sp.csr_matrix      # zipf_smoothing_alpha(adj, alpha)
    adjacency: sp.csr_matrix     # symmetrised 0/1 adjacency
    features: np.ndarray         # (n, d) float32, row-normalised
    labels: np.ndarray           # (n,) int32
    idx_train: np.ndarray
    idx_val: np.ndarray
    idx_test: np.ndarray


def _read_parts(data_dir: str, name: str):
    objects = []
    for part in _PARTS:
        path = os.path.join(data_dir, name, f"ind.{name}.{part}")
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            raise FileNotFoundError(
                f"missing Planetoid file {path} — for pubmed the standard "
                f"ind.pubmed.allx must be fetched separately (absent upstream)")
        with open(path, "rb") as f:
            objects.append(pickle.load(f, encoding="latin1"))
    test_idx = np.loadtxt(os.path.join(data_dir, name,
                                       f"ind.{name}.test.index"),
                          dtype=np.int64)
    return objects, test_idx


def load_planetoid(name: str = "cora", alpha: float = 0.5,
                   data_dir: str = "data") -> Planetoid:
    name = name.lower()
    if name not in DATASETS and not os.path.isdir(os.path.join(data_dir, name)):
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS} or "
                         f"provide ind.* files under {data_dir}/{name}/ "
                         f"(tools/make_synthetic_planetoid.py emits the format)")
    (x, y, tx, ty, allx, ally, graph), test_idx_reorder = _read_parts(
        data_dir, name)
    test_idx_range = np.sort(test_idx_reorder)

    if name == "citeseer":
        # isolated test nodes: widen tx / ty to the full test-index range
        # with zero rows so that the indices line up
        full = range(test_idx_reorder.min(), test_idx_reorder.max() + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - test_idx_reorder.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), ty.shape[1]))
        ty_ext[test_idx_range - test_idx_reorder.min(), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    labels_onehot = np.vstack((ally, ty))
    labels_onehot[test_idx_reorder, :] = labels_onehot[test_idx_range, :]

    # adjacency from the neighbour dict; directed citations -> symmetric 0/1
    rows, cols = [], []
    for src, nbrs in graph.items():
        rows.extend([src] * len(nbrs))
        cols.extend(nbrs)
    n = labels_onehot.shape[0]
    adj = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    adj = adj + adj.T
    adj.data[:] = np.minimum(adj.data, 1.0)

    n_train = y.shape[0]
    idx_train = np.arange(n_train)
    idx_val = np.arange(n_train, n_train + 500)
    idx_test = test_idx_range

    features = row_normalization(sp.csr_matrix(features))
    operator = zipf_smoothing_alpha(adj, alpha)

    labels = labels_onehot.argmax(1).astype(np.int32)
    return Planetoid(operator=operator.tocsr(), adjacency=adj.tocsr(),
                     features=np.asarray(features.todense(), np.float32),
                     labels=labels,
                     idx_train=idx_train.astype(np.int32),
                     idx_val=idx_val.astype(np.int32),
                     idx_test=idx_test.astype(np.int32))
