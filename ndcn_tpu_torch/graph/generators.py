"""Synthetic graph construction (host side, numpy / scipy / networkx).

A copy of ``ndcn_tpu/graph/generators.py`` (importing that package would
pull in jax): the 8-neighbor grid, the networkx graph zoo (Erdős–Rényi,
Barabási–Albert, Newman–Watts–Strogatz, random-partition communities) with
the community / degree node reordering, plus ``build_sparse_graph`` from
``examples/large_graph.py``. Same seeds, same graphs: the tests hold them
bit-equal to the JAX package's; and ``girvan_newman_labels``. networkx is
imported only by the kinds and the labelling that need it; the grid and the
sparse builders run without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

NETWORKS = ("grid", "random", "power_law", "small_world", "community")
LAYOUTS = ("community", "degree", None)


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


def _networkx():
    try:
        import networkx
    except ImportError as e:
        raise ImportError("the networkx graph kinds (random, power_law, "
                          "small_world, community) need the networkx "
                          "package; the grid does not") from e
    return networkx


def generate_node_mapping(g, kind: Optional[str] = None):
    """Node relabeling by degree rank or by modularity-community blocks."""
    if kind == "degree":
        ranked = sorted(g.degree, key=lambda kv: kv[1], reverse=True)
        return {node: i for i, (node, _) in enumerate(ranked)}
    if kind == "community":
        nx = _networkx()
        blocks = list(nx.algorithms.community.greedy_modularity_communities(g))
        order = [node for block in blocks for node in block]
        return {node: i for i, node in enumerate(order)}
    return None


def reorder_nodes(g, kind: Optional[str] = None):
    """Permute node ids so that adjacency plots show block structure."""
    mapping = generate_node_mapping(g, kind)
    if mapping is None:
        return g
    nx = _networkx()
    coo = nx.to_scipy_sparse_array(g, format="coo")
    row = np.array([mapping[r] for r in coo.row], dtype=np.int64)
    col = np.array([mapping[c] for c in coo.col], dtype=np.int64)
    permuted = sp.coo_matrix((coo.data, (row, col)), shape=coo.shape)
    return nx.from_scipy_sparse_array(permuted)


def build_network(kind: str, n: int, seed: int = 0,
                  layout: Optional[str] = "community") -> np.ndarray:
    """The --network switch of the dynamics drivers; a dense float32
    adjacency.

    random: ER(p=.1); power_law: BA(m=5); small_world: NWS(400, 5, .5),
    400 nodes whatever ``n`` is (as in the reference); community:
    random_partition([n/3, n/3, n/4, rest], .25, .01); each reordered by
    ``layout``. The grid uses ceil(sqrt(n))² nodes with 8-neighbor
    connectivity and no reordering."""
    if kind == "grid":
        side = int(np.ceil(np.sqrt(n)))
        return grid_8_neighbor_adjacency(side)
    if kind not in NETWORKS:
        raise ValueError(f"unknown network kind {kind!r}; choose from "
                         f"{NETWORKS}")
    nx = _networkx()
    if kind == "random":
        g = nx.erdos_renyi_graph(n, 0.1, seed=seed)
    elif kind == "power_law":
        g = nx.barabasi_albert_graph(n, 5, seed=seed)
    elif kind == "small_world":
        g = nx.newman_watts_strogatz_graph(400, 5, 0.5, seed=seed)
    else:
        n1 = n2 = int(n / 3)
        n3 = int(n / 4)
        n4 = n - n1 - n2 - n3
        g = nx.random_partition_graph([n1, n2, n3, n4], 0.25, 0.01, seed=seed)
    g = reorder_nodes(g, layout)
    return np.asarray(nx.to_numpy_array(g), dtype=np.float32)


def girvan_newman_labels(adj: np.ndarray, n_splits: int = 10) -> np.ndarray:
    """Community labels by Girvan-Newman edge-betweenness splitting (the
    reference's relabelling of citation graphs, a side experiment).

    Takes ``n_splits`` steps of the divisive hierarchy and labels each node
    by its community's index (1-based, as the reference). Needs networkx."""
    nx = _networkx()
    g = nx.from_numpy_array(np.asarray(adj))
    gen = nx.algorithms.community.girvan_newman(g)
    communities = None
    for _ in range(n_splits):
        try:
            communities = next(gen)
        except StopIteration:
            break
    labels = np.zeros(g.number_of_nodes(), dtype=np.int32)
    if communities is not None:
        for i, block in enumerate(communities, start=1):
            for node in block:
                labels[node] = i
    return labels


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
