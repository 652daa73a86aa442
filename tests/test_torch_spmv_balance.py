"""The chunk index that spreads long CSR rows over many warps, the plain
versions of K1's chunked fold and of K1-fm's pack step, and the SpMV
wrappers on a hub graph against the JAX package, all on the CPU.

Inputs come from numpy seeds. Bars:
- the index: every edge of every row is covered exactly once and in order,
  by its row (short rows) or by its row's chunks (long rows);
- the plain chunked fold against ``coo_spmv_plain``: max|Δ|/max|y| <= 2e-6
  (the same fp32 products; a long row's sum of up to 1.5k of them is taken
  chunk by chunk, and fp32 sums of that length in another order differ by
  about 1e-6 of the largest entry); rows left whole agree bit for bit;
- the plain pack: bit-equal to ``xT.t().contiguous()`` in fp32 and to its
  bf16 rounding in bf16;
- ``coo_spmv`` / ``spmv_T`` on a graph with a 1,500-edge row, forward and
  gradient, against the JAX package's ``tiled_spmv`` / ``spmv_T`` in Pallas
  interpret mode: max|Δ|/max|y| <= 1e-5 in fp32 (JAX's two-term bf16 split),
  <= 1e-4 in bf16 (the same rounded products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ndcn_tpu.graph.sparse as j_gs
import ndcn_tpu.kernels.coo_spmv as j_ck
from ndcn_tpu_torch.graph import sparse as gs
from ndcn_tpu_torch.kernels import coo_spmv as ck


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _random_graph(n, m, seed):
    rng = np.random.RandomState(seed)
    a = sp.coo_matrix((rng.randn(m).astype(np.float32),
                       (rng.randint(0, n, m), rng.randint(0, n, m))),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def _hub_graph(n=2000, m=20_000, hub=1500, seed=3):
    """A power-law graph with one row of ``hub`` edges more (row 7): the hub
    graph of the GPU smoke run, shrunk."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([rng.zipf(1.5, m) % n, np.full(hub, 7)])
    cols = np.concatenate([rng.randint(0, n, m),
                           rng.choice(n, hub, replace=False)])
    a = sp.coo_matrix((rng.randn(rows.size).astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def _with_empty_rows(n=500, seed=5):
    """Every third row empty, and two rows far above the split limit."""
    a = _random_graph(n, 6000, seed).tolil()
    a[::3] = 0
    rng = np.random.RandomState(seed)
    for row, deg in ((1, 400), (n - 1, 333)):
        a[row, rng.choice(n, deg, replace=False)] = rng.randn(deg)
    a = a.tocsr().astype(np.float32)
    a.eliminate_zeros()
    return a


GRAPHS = {
    "random": lambda: _random_graph(700, 9000, 0),
    "hub": _hub_graph,
    "empty_rows": _with_empty_rows,
    # n is no multiple of the kernels' 32-row blocks or 8-row warps
    "ragged_n": lambda: _hub_graph(n=1237, m=9000, hub=700, seed=9),
}


@pytest.mark.parametrize("limit", [1, 7, 64, 256])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_chunk_index_covers_every_edge_once_and_in_order(graph, limit):
    a = GRAPHS[graph]()
    row_ptr = a.indptr.astype(np.int64)
    split = ck.split_rows(row_ptr, limit)
    lens = np.diff(row_ptr)
    long_rows = split.long_rows.numpy()
    chunk_ptr = split.chunk_ptr.numpy()
    bounds = split.chunk_bounds.numpy()
    assert split.limit == limit
    assert all(t.dtype == torch.int32 for t in split[:3])
    assert np.array_equal(long_rows, np.flatnonzero(lens > limit))
    assert chunk_ptr.shape == (long_rows.size + 1,) and chunk_ptr[0] == 0
    assert bounds.shape == (chunk_ptr[-1], 2)
    covered = np.zeros(a.nnz, np.int64)
    for row in np.flatnonzero(lens <= limit):
        covered[row_ptr[row]:row_ptr[row + 1]] += 1
    for j, row in enumerate(long_rows):
        mine = bounds[chunk_ptr[j]:chunk_ptr[j + 1]]
        assert len(mine) == -(-lens[row] // limit) >= 2
        # consecutive, in order, from the row's first edge to its last
        assert mine[0, 0] == row_ptr[row] and mine[-1, 1] == row_ptr[row + 1]
        assert np.array_equal(mine[1:, 0], mine[:-1, 1])
        sizes = mine[:, 1] - mine[:, 0]
        assert (sizes[:-1] == limit).all() and 0 < sizes[-1] <= limit
        for lo, hi in mine:
            covered[lo:hi] += 1
    assert (covered == 1).all()


def test_operator_carries_the_index_of_both_directions():
    a = _hub_graph()
    op = gs.from_scipy_coo(a)
    assert op.split.limit == op.split_t.limit == ck.SPLIT_EDGES == 256
    lens = np.diff(a.indptr)
    assert lens.max() >= 1500
    assert np.array_equal(op.split.long_rows.numpy(),
                          np.flatnonzero(lens > 256))
    lens_t = np.diff(a.T.tocsr().indptr)
    assert np.array_equal(op.split_t.long_rows.numpy(),
                          np.flatnonzero(lens_t > 256))
    t = op.transpose()
    assert t.split is op.split_t and t.split_t is op.split
    assert t.row_ptr is op.row_ptr_t and t.n == op.n
    # a graph without long rows has an empty index
    flat = gs.from_scipy_coo(_random_graph(300, 2000, 1))
    assert flat.split.long_rows.numel() == 0
    assert flat.split.chunk_bounds.shape == (0, 2)
    assert flat.split.chunk_ptr.tolist() == [0]
    with pytest.raises(ValueError, match="limit"):
        ck.split_rows(a.indptr, 0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("limit", [64, 256])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_plain_chunked_fold_matches_the_unsplit_sum(graph, limit, bf16):
    a = GRAPHS[graph]()
    op = gs.from_scipy_coo(a)
    x = torch.as_tensor(np.random.RandomState(1).randn(op.n, 20)
                        .astype(np.float32))
    for half in (op, op.transpose()):
        split = ck.split_rows(half.row_ptr.numpy(), limit)
        got = ck.coo_spmv_split_plain(half.row_ptr, half.cols, half.vals,
                                      split, x, bf16)
        ref = ck.coo_spmv_plain(half.rows, half.cols, half.vals, x, half.n,
                                bf16)
        assert max_rel(got, ref) <= 2e-6
        # rows the index leaves whole are summed as before, bit for bit
        whole = np.diff(half.row_ptr.numpy()) <= limit
        assert torch.equal(got[whole], ref[whole])


@pytest.mark.parametrize("limit", [16, 64, 256])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_heavy_rows_are_the_rows_walked_whole_past_heavy_edges(graph, limit):
    """The heavy rows K1's wide form starts first: every row of more than
    ``HEAVY_EDGES`` and at most ``limit`` edges, once and in order (none of
    the chunked rows)."""
    a = GRAPHS[graph]()
    lens = np.diff(a.indptr)
    split = ck.split_rows(a.indptr, limit)
    heavy = split.heavy_rows.numpy()
    assert split.heavy_rows.dtype == torch.int32
    assert heavy.tolist() == np.flatnonzero(
        (lens > ck.HEAVY_EDGES) & (lens <= limit)).tolist()
    assert not set(heavy.tolist()) & set(split.long_rows.tolist())


def test_plain_chunked_fold_refuses_a_wrong_index():
    op = gs.from_scipy_coo(_hub_graph())
    x = torch.ones(op.n, 3)
    bad = op.split._replace(chunk_bounds=op.split.chunk_bounds[:-1])
    with pytest.raises(ValueError, match="cover"):
        ck.coo_spmv_split_plain(op.row_ptr, op.cols, op.vals, bad, x)


@pytest.mark.parametrize("d_sub,n", [(8, 100), (24, 1237), (40, 64),
                                     (136, 33)])
def test_plain_pack_is_the_transpose_copy(d_sub, n):
    xT = torch.as_tensor(np.random.RandomState(d_sub).randn(d_sub, n)
                         .astype(np.float32))
    before = ck.PACK_LAUNCHES
    table = ck.pack_rows(xT)                 # CPU: the plain version
    assert ck.PACK_LAUNCHES == before
    assert table.shape == (n, d_sub) and table.is_contiguous()
    assert torch.equal(table, xT.t().contiguous())
    assert torch.equal(ck.pack_rows_plain(xT), table)
    rounded = ck.pack_rows(xT, bf16=True)
    assert rounded.dtype == torch.bfloat16 and rounded.is_contiguous()
    assert torch.equal(rounded.float(), ck.round_bf16(xT).t().contiguous())
    with pytest.raises(ValueError, match="contiguous float32"):
        ck.pack_rows(xT.t())
    with pytest.raises(ValueError, match="contiguous float32"):
        ck.pack_rows(xT.double())


def _feature_major(x):
    d = x.shape[1]
    return np.ascontiguousarray(
        np.pad(x, ((0, 0), (0, ck.sublane_pad(d) - d))).T)


@pytest.mark.parametrize("bf16", [False, True])
def test_coo_spmv_on_the_hub_graph_matches_jax_tiled_spmv(bf16, monkeypatch):
    a = _hub_graph()
    rng = np.random.RandomState(2)
    x = rng.randn(2000, 20).astype(np.float32)
    g = rng.randn(2000, 20).astype(np.float32)
    monkeypatch.setattr(ck, "GATHER_BF16", bf16)
    monkeypatch.setattr(j_ck, "GATHER_BF16", bf16)
    op = gs.from_scipy_coo(a)
    xt = torch.as_tensor(x).requires_grad_()
    y = ck.coo_spmv(op, xt)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(g)).sum(), xt)
    jop = j_gs.from_scipy_coo(a, tiled=True)
    jy = j_ck.tiled_spmv(jop.tiles, jop.tiles_t, jnp.asarray(x))
    jdx = jax.grad(lambda xx: jnp.sum(j_ck.tiled_spmv(
        jop.tiles, jop.tiles_t, xx) * jnp.asarray(g)))(jnp.asarray(x))
    tol = 1e-4 if bf16 else 1e-5
    assert max_rel(y.detach().numpy(), jy) <= tol
    assert max_rel(dx.numpy(), jdx) <= tol
    # and the chunked fold over the operator's own index agrees with both
    for half, inp, ref in ((op, x, y.detach()), (op.transpose(), g, dx)):
        folded = ck.coo_spmv_split_plain(half.row_ptr, half.cols, half.vals,
                                         half.split, torch.as_tensor(inp),
                                         bf16)
        assert max_rel(folded, ref) <= 1e-6


@pytest.mark.parametrize("bf16", [False, True])
def test_spmv_T_on_the_hub_graph_matches_jax_spmv_T(bf16, monkeypatch):
    a = _hub_graph()
    rng = np.random.RandomState(4)
    xT = _feature_major(rng.randn(2000, 20).astype(np.float32))
    ct = _feature_major(rng.randn(2000, 20).astype(np.float32))
    for mod in (ck, j_ck):
        monkeypatch.setattr(mod, "GATHER_WIDE", False)
        monkeypatch.setattr(mod, "GATHER_BF16", bf16)
    op = gs.from_scipy_coo(a)
    x = torch.as_tensor(xT).requires_grad_()
    y = ck.spmv_T(op, x)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), x)
    jop = j_gs.from_scipy_coo(a, tiled=True)
    jy = j_ck.spmv_T(jop.tiles, jop.tiles_t, jnp.asarray(xT))
    jdx = jax.grad(lambda xx: jnp.sum(
        j_ck.spmv_T(jop.tiles, jop.tiles_t, xx) * jnp.asarray(ct)))(
        jnp.asarray(xT))
    tol = 1e-4 if bf16 else 1e-5
    assert y.shape == (24, 2000) and dx.shape == (24, 2000)
    assert max_rel(y.detach().numpy(), jy) <= tol
    assert max_rel(dx.numpy(), jdx) <= tol
    assert not y[20:].any() and not dx[20:].any()   # pad rows stay zero
    # K1-fm's two steps in their plain versions: pack, then the chunked fold
    # over the packed table, give the feature-major answer
    table = ck.pack_rows(torch.as_tensor(xT), bf16).float()
    folded = ck.coo_spmv_split_plain(op.row_ptr, op.cols, op.vals, op.split,
                                     table, bf16).t()
    assert max_rel(folded, y.detach()) <= 1e-6


@pytest.mark.parametrize("bf16", [False, True])
def test_spmv_T_wide_on_the_hub_graph_matches_jax_spmv_T_wide(bf16,
                                                              monkeypatch):
    """K5's path (``GATHER_WIDE``) on the hub graph against the JAX
    package's wide ``spmv_T`` (``_spmv_T_wide``, the Pallas kernel in
    interpret mode), forward and gradient; on the card K5 is the shared
    gather with the chunk index over a copied table, here its plain
    version."""
    a = _hub_graph()
    rng = np.random.RandomState(5)
    xT = _feature_major(rng.randn(2000, 20).astype(np.float32))
    ct = _feature_major(rng.randn(2000, 20).astype(np.float32))
    for mod in (ck, j_ck):
        monkeypatch.setattr(mod, "GATHER_WIDE", True)
        monkeypatch.setattr(mod, "GATHER_BF16", bf16)
    op = gs.from_scipy_coo(a)
    assert op.split.long_rows.numel() > 0
    x = torch.as_tensor(xT).requires_grad_()
    y = ck.spmv_T(op, x)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), x)
    jop = j_gs.from_scipy_coo(a, tiled=True)
    jy = j_ck.spmv_T(jop.tiles, jop.tiles_t, jnp.asarray(xT))
    jdx = jax.grad(lambda xx: jnp.sum(
        j_ck.spmv_T(jop.tiles, jop.tiles_t, xx) * jnp.asarray(ct)))(
        jnp.asarray(xT))
    tol = 1e-4 if bf16 else 1e-5
    assert y.shape == (24, 2000) and dx.shape == (24, 2000)
    assert max_rel(y.detach().numpy(), jy) <= tol
    assert max_rel(dx.numpy(), jdx) <= tol
    assert not y[20:].any() and not dx[20:].any()   # pad rows stay zero
