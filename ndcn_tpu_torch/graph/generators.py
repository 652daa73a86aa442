"""Synthetic graph construction (host side, numpy / scipy).

A copy of the grid builders of ``ndcn_tpu/graph/generators.py`` (importing
that package would pull in jax), plus ``build_sparse_graph`` from
``examples/large_graph.py``. Same seeds, same graphs: the tests hold them
bit-equal to the JAX package's. The networkx graph zoo (random, power_law,
small_world, community) comes with the training drivers (ROADMAP item 3).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

NETWORKS = ("grid", "random", "power_law", "small_world", "community")


def grid_8_neighbor_adjacency(side: int) -> np.ndarray:
    """Adjacency of a side×side grid where each cell connects to its 8 neighbors."""
    side = int(side)
    xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()  # node i = x * side + y
    a = np.zeros((side * side, side * side), dtype=np.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            nxs, nys = xs + dx, ys + dy
            valid = (nxs >= 0) & (nxs < side) & (nys >= 0) & (nys < side)
            a[xs[valid] * side + ys[valid], nxs[valid] * side + nys[valid]] = 1.0
    return a


def build_network(kind: str, n: int) -> np.ndarray:
    """The --network switch of the dynamics drivers; a dense float32 adjacency.

    The grid uses ceil(sqrt(n))² nodes with 8-neighbor connectivity and no
    reordering."""
    if kind == "grid":
        side = int(np.ceil(np.sqrt(n)))
        return grid_8_neighbor_adjacency(side)
    if kind in NETWORKS:
        raise NotImplementedError(f"network {kind!r} is not ported yet: "
                                  f"ROADMAP item 3")
    raise ValueError(f"unknown network kind {kind!r}; choose from {NETWORKS}")


def grid_block_initial_value(side: int) -> np.ndarray:
    """The three-hot-block initial condition of the dynamics scripts:
    25/20/17-valued rectangles on the side×side grid, as a (side², 1)
    float32 column."""
    x0 = np.zeros((side, side), dtype=np.float32)
    x0[int(0.05 * side):int(0.25 * side), int(0.05 * side):int(0.25 * side)] = 25.0
    x0[int(0.45 * side):int(0.75 * side), int(0.45 * side):int(0.75 * side)] = 20.0
    x0[int(0.05 * side):int(0.25 * side), int(0.35 * side):int(0.65 * side)] = 17.0
    return x0.reshape(-1, 1)


def build_sparse_graph(n: int, avg_degree: int, seed: int) -> sp.csr_matrix:
    """Random symmetric graph with ~avg_degree edges per node, no dense step
    (copied from ``examples/large_graph.py::build_sparse_graph``, the repo's
    200k-node / 2M-edge scale setting)."""
    rng = np.random.RandomState(seed)
    m = n * avg_degree // 2
    rows = rng.randint(0, n, size=m)
    cols = rng.randint(0, n, size=m)
    keep = rows != cols
    a = sp.coo_matrix((np.ones(keep.sum(), np.float32),
                       (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    a = a + a.T
    a.data[:] = 1.0
    return a
