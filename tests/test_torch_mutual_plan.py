"""K1-w's launch plan (``kernels.coo_mutual.mutual_plan``) and its plain
version on the graphs that the edge form's schedule finds hard, against the
JAX package's ``_coo_mutual_inter`` through its Pallas reduce in interpret
mode (``_use_tiles`` patched, as ``tests/test_torch_dynamics.py`` does).

The graphs are cut to the plan's own edge counts: empty rows (leading,
trailing, every fourth), a hub row longer than a CTA's edge range, and rows
that straddle a warp's and a CTA's boundary. Bars: the forward within
1e-6 rel-L1 of the same sum in float64, and within 2e-6 of the JAX
package's (whose Pallas reduce is itself 0.8-1.03e-6 off the float64 sum
on these graphs: it accumulates in split bf16); the gradient within 1e-5
rel-L1 of ``jax.grad``'s (fp32 sums in another order).
"""

import gc
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.dynamics import rhs as j_rhs
from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu_torch.graph.sparse import from_scipy_coo
from ndcn_tpu_torch.kernels import coo_mutual
from ndcn_tpu_torch.kernels.coo_mutual import (EDGE_MAX_WIDTH, EDGE_THREADS,
                                               mutual_plan)

EDGE_WIDTHS = tuple(range(1, EDGE_MAX_WIDTH + 1))

SOURCE = (Path(coo_mutual.__file__).resolve().parent.parent / "csrc"
          / "coo_mutual_edges.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, as ``tests/test_torch_dynamics.py``: the
    default pool contends for the cores with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def _thread_ranges(plan, nnz):
    """Each thread's edges under the plan, in (CTA, thread) order."""
    ept = plan.edges_per_thread
    for b in range(plan.ctas):
        for t in range(EDGE_THREADS):
            lo = b * plan.cta_edges + t * ept
            yield b, np.arange(lo, min(lo + ept, nnz))


@pytest.mark.parametrize("d", EDGE_WIDTHS)
@pytest.mark.parametrize("nnz", [1, 255, 1023, 1024, 1025, 30001])
def test_edge_ranges_cover_every_edge_once_and_in_order(d, nnz):
    plan = mutual_plan(d, nnz)
    ept = plan.edges_per_thread
    assert plan.cta_edges == EDGE_THREADS * ept
    assert (plan.ctas - 1) * plan.cta_edges < nnz <= plan.ctas * plan.cta_edges
    covered = [(b, e) for b, e in _thread_ranges(plan, nnz) if e.size]
    assert np.array_equal(np.concatenate([e for _, e in covered]),
                          np.arange(nnz))
    # every CTA holds an edge, so each has its first run: where the CSR
    # has long rows, two carry slots a CTA (the second empty only when the
    # CTA is one run); else none, each CTA reading on to its last row's end
    assert {b for b, _ in covered} == set(range(plan.ctas))
    assert plan.carry_slots == 0
    carried = mutual_plan(d, nnz, long_rows=True)
    assert carried._replace(carry_slots=0) == plan
    assert carried.carry_slots == 2 * plan.ctas


def test_crossover_is_by_width(monkeypatch):
    for d in range(1, 41):
        plan = mutual_plan(d, 10_000)
        assert plan.form == ("edges" if d <= EDGE_MAX_WIDTH else "rows"), d
        if plan.form == "rows":
            assert plan == (("rows",) + (0,) * 4)
    # a state whose rows are off their alignment takes the warp form
    assert mutual_plan(1, 10_000, aligned=False).form == "rows"
    assert coo_mutual.row_load(6) == 2 and coo_mutual.row_load(8) == 4
    assert coo_mutual.row_load(7) == 1
    assert mutual_plan(1, 0).ctas == 0
    # the crossover is read at each call: with it at 0 every width takes
    # the warp form (how the sweep and the card tests time and hold it)
    monkeypatch.setattr(coo_mutual, "EDGE_MAX_WIDTH", 0)
    assert {mutual_plan(d, 10_000).form for d in range(1, 41)} == {"rows"}


def test_edge_form_rows_are_made_once_per_operator():
    """The int32 rows the edge form reads are made at the first call that
    needs them, one copy for A's rows and one for Aᵀ's, and are let go
    with the operator's rows."""
    a = edge_form_graph("empty_rows", 1)
    op = from_scipy_coo(a)
    r32 = coo_mutual.rows32(op.rows)
    assert r32.dtype == torch.int32 and torch.equal(r32.long(), op.rows)
    assert coo_mutual.rows32(op.rows) is r32
    r32_t = coo_mutual.rows32(op.transpose().rows)
    assert torch.equal(r32_t.long(), op.rows_t) and r32_t is not r32
    rows = op.rows.clone()
    coo_mutual.rows32(rows)
    held = len(coo_mutual._ROWS32)
    del rows
    gc.collect()
    assert len(coo_mutual._ROWS32) == held - 1


def test_widths_are_the_ones_the_source_builds():
    """``for_edge_instance`` in ``csrc/coo_mutual_edges.cu`` dispatches exactly
    the widths 1 to ``EDGE_MAX_WIDTH``, and the kernel's edges a thread are
    the plan's."""
    text = SOURCE.read_text()
    body = text[text.index("bool for_edge_instance("):]
    body = body[:body.index("\n}\n")]
    built = [int(d) for d, w in re.findall(
        r"case (\d+): return by_side\(integral_constant<int, (\d+)>", body)
        if d == w]
    assert tuple(built) == EDGE_WIDTHS
    assert re.search(r"constexpr int kEdgesPerThread = (\d+);",
                     text).group(1) == str(coo_mutual.EDGES_PER_THREAD)


def edge_form_graph(kind: str, d: int, seed: int = 0) -> sp.csr_matrix:
    """A non-symmetric graph cut to the edge form's plan at width d:
    ``empty_rows`` (the first 11, the last 13 and every fourth row empty),
    ``hub`` (a row of 3 CTAs' edges and 17 more, empty rows around it) or
    ``straddle`` (a row across the first CTA boundary and one across a
    warp boundary inside a CTA)."""
    plan = mutual_plan(d, 0)
    cta, warp = plan.cta_edges, 32 * plan.edges_per_thread
    rng = np.random.RandomState(seed)
    n = 3 * cta + 900
    deg = rng.randint(0, 9, n)
    if kind == "empty_rows":
        deg[::4] = 0
        deg[:11] = 0
        deg[-13:] = 0
    elif kind == "hub":
        deg[n // 3 - 2:n // 3 + 3] = 0
        deg[n // 3] = 3 * cta + 17
    if kind == "straddle":   # the row of edge - 1 ends after edge
        for edge in (warp * 3, cta):
            ptr = np.concatenate([[0], np.cumsum(deg)])
            r = int(np.searchsorted(ptr, edge - 1, side="right")) - 1
            deg[r] += 5 * (ptr[r + 1] == edge)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    vals = (rng.rand(ptr[-1]) + 0.1).astype(np.float32)
    a = sp.csr_matrix((vals, cols, ptr), shape=(n, n))
    if kind == "straddle":
        for edge in (cta, warp * 3):
            r = int(np.searchsorted(ptr, edge, side="right")) - 1
            assert ptr[r] < edge < ptr[r + 1]
    return a


@pytest.mark.parametrize("kind", ["empty_rows", "hub", "straddle"])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("convention", ["reference", "paper"])
def test_k1w_plain_matches_the_pallas_reduce_on_edge_form_graphs(
        monkeypatch, convention, d, kind):
    """K1-w's plain version (the CPU path of ``coo_mutual_inter``) against
    the JAX package's tiled interaction, forward and gradient."""
    monkeypatch.setattr(j_rhs, "_use_tiles", lambda op: op.tiles is not None)
    a = edge_form_graph(kind, d, seed=d)
    n = a.shape[0]
    assert mutual_plan(d, a.nnz).form == "edges"
    op = from_scipy_coo(a)
    j_op = j_from_scipy_coo(a, tiled=True)
    rng = np.random.RandomState(d + 7)
    x = (rng.rand(n, d) * 3 + 0.2).astype(np.float32)
    ct = rng.randn(n, d).astype(np.float32)
    e, h = (0.1, 0.9) if convention == "reference" else (0.9, 0.1)

    def j_inter(xx):
        return j_rhs._coo_mutual_inter(j_op, xx, 5.0, e, h)

    y_j = np.asarray(j_inter(jnp.asarray(x)))
    g_j = np.asarray(jax.grad(lambda xx: jnp.sum(j_inter(xx) * ct))(
        jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_()
    y = coo_mutual.coo_mutual_inter(op, xt, 5.0, e, h)
    (g,) = torch.autograd.grad((y * torch.as_tensor(ct)).sum(), xt)
    y64 = coo_mutual.mutual_forward_plain(
        op._replace(vals=op.vals.double()), torch.as_tensor(x).double(),
        5.0, e, h)
    assert rel_l1(y.detach(), y64) <= 1e-6
    assert rel_l1(y.detach(), y_j) <= 2e-6
    assert rel_l1(g, g_j) <= 1e-5
    empty = np.flatnonzero(np.diff(a.indptr) == 0)
    assert not y.detach()[empty].any() and not y_j[empty].any()
