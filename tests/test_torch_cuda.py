"""The port's CUDA kernels on the GPU, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no jax, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Bounds: max|Δ| <= 1e-5·max|y| for K1 (fp32 and bf16), K1ᵀ, K1-w (forward
and backward), K1-fm, K5, K3,
K4, the sliced-tile reduce and the row gather (exact; K1-fm's pack kernel
too), and rtol 1e-5 /
atol 1e-5·max|y| for K2 and its backward (fp32 sums in another order; K2,
K3 and K4 multiply in split TF32, which keeps fp32's digits); 2e-6·max|y|
for K2, K3 and K4 against the plain PyTorch emulation of their split
arithmetic (the same roundings, summed in another order); 1e-4
rel-L1 for a served trajectory on the GPU against the same server on the CPU
(for the other solvers, or twice the CPU's own float32-vs-float64 distance
where that is larger), and 1e-3 rel-L1 for a train step's gradients on the
GPU against the CPU, the continuous adjoint's against its fixture too.
Backward checks use non-symmetric matrices. The scan path's train step as
a CUDA graph (``train.chunk``) is bit-equal to the same steps run eagerly
(dopri5, the Adams family, the continuous adjoint, and a row block over a
one-rank NCCL group), and K2 and K4 are bit-equal under ``--precision
high``.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu_torch import kernels
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import (DenseGraph, as_operator,
                                         from_scipy_coo)
from ndcn_tpu_torch.kernels import (bsr_spmm, coo_mutual, coo_spmv, fused_rhs,
                                    sparse_bench)
from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
from ndcn_tpu_torch.serve import make_server

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA")
    return torch.device("cuda")


def _power_law_coo(n, m, seed, d):
    rng = np.random.RandomState(seed)
    rows = rng.zipf(1.5, m) % n
    cols = rng.randint(0, n, m)
    a = sp.coo_matrix((rng.randn(m).astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a, rng.randn(n, d).astype(np.float32)


def _fused_inputs(n, k, seed, device):
    rng = np.random.RandomState(seed)
    return tuple(torch.as_tensor(t, device=device) for t in (
        rng.rand(n, n).astype(np.float32), rng.rand(n, k).astype(np.float32),
        rng.randn(k, k).astype(np.float32), rng.randn(k).astype(np.float32)))


@pytest.mark.parametrize("d", [1, 7, 20, 40])
def test_k1_cuda_matches_plain(cuda_device, d):
    a, x = _power_law_coo(2000, 30000, seed=d, d=d)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x, device=cuda_device)
    before = coo_spmv.LAUNCHES
    y = coo_spmv.coo_spmv(op, x)
    ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)
    torch.cuda.synchronize()
    assert coo_spmv.LAUNCHES == before + 1
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(y, coo_spmv.coo_spmv(op, x))  # no atomics: repeatable


@pytest.mark.parametrize("n,k", [(400, 20), (275, 13), (70, 33), (64, 300),
                                 (1000, 20), (4000, 64), (2049, 128),
                                 (64, 1024)])
def test_k2_cuda_matches_plain(cuda_device, n, k):
    a, h, w, b = _fused_inputs(n, k, seed=k, device=cuda_device)
    before = fused_rhs.LAUNCHES
    y = fused_rhs.fused_rhs(a, h, w.t().contiguous().t(), b)
    ref = fused_rhs.fused_rhs_plain(a, h, w, b)
    torch.cuda.synchronize()
    assert fused_rhs.LAUNCHES == before + 1
    scale = float(ref.abs().max())
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n,k", [(400, 20), (275, 13), (1000, 20), (2049, 128),
                                 (4000, 64), (64, 1024)])
def test_k2_cuda_repeats_and_matches_split_emulation(cuda_device, n, k):
    """Two calls bit-equal (fixed order, no atomics); within 2e-6 of the plain
    PyTorch emulation of the split product; a contiguous W, the transposed
    view nn.Linear hands over and a view with no unit stride give the same
    bits for the same values."""
    a, h, w, b = _fused_inputs(n, k, seed=k + 1, device=cuda_device)
    y = fused_rhs.fused_rhs(a, h, w, b)
    assert torch.equal(y, fused_rhs.fused_rhs(a, h, w, b))
    assert torch.equal(y, fused_rhs.fused_rhs(a, h, w.t().contiguous().t(), b))
    spread = torch.zeros(2 * k, 3 * k, device=cuda_device)
    spread[::2, ::3] = w                  # a view with no unit stride
    assert torch.equal(y, fused_rhs.fused_rhs(a, h, spread[::2, ::3], b))
    emu = fused_rhs.fused_rhs_split_plain(a, h, w, b)
    assert float((y - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
    one_pass = fused_rhs.fused_rhs_split_plain(a, h, w, b, passes=1)
    assert float((y - one_pass).abs().max()) > 1e-5 * float(emu.abs().max())


def test_k2_cuda_keeps_nan_and_takes_every_plan(cuda_device, monkeypatch):
    """relu keeps a NaN (the solver's finite check reads it); every panel
    height and chunk depth the kernel is built for gives the plan's
    answer; a plan whose shared-memory size is not the layout's is
    refused."""
    a, h, w, b = _fused_inputs(300, 40, seed=3, device=cuda_device)
    bad = h.clone()
    bad[5, 7] = float("nan")
    assert torch.isnan(fused_rhs.fused_rhs(a, bad, w, b)).any()
    ref = fused_rhs.fused_rhs(a, h, w, b)
    base = fused_rhs.fused_rhs_plan(300, 40)
    for rows in (16, 32):
        for bk in (32, 64, 128):
            plan = base._replace(rows=rows, bk=bk,
                                 smem_bytes=fused_rhs.plan_smem_bytes(
                                     rows, base.nt, base.wk, bk, 40))
            monkeypatch.setattr(fused_rhs, "fused_rhs_plan",
                                lambda n, k, plan=plan: plan)
            got = fused_rhs.fused_rhs(a, h, w, b)
            # another chunk depth folds the sum in other places
            assert _max_rel(got, ref) <= 2e-6
    monkeypatch.setattr(fused_rhs, "fused_rhs_plan",
                        lambda n, k: base._replace(smem_bytes=base.smem_bytes
                                                   + 4))
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_rhs.fused_rhs(a, h, w, b)


def _max_rel(y, ref):
    y, ref = y.detach(), ref.detach()
    return float((y - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("d", [7, 20, 40])
def test_k1_bf16_cuda_matches_plain(cuda_device, d, monkeypatch):
    a, x = _power_law_coo(2000, 30000, seed=d + 1, d=d)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x, device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", True)
    before = coo_spmv.BF16_LAUNCHES
    y = coo_spmv.coo_spmv(op, x)
    ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n, True)
    torch.cuda.synchronize()
    assert coo_spmv.BF16_LAUNCHES == before + 1
    assert _max_rel(y, ref) <= 1e-5
    fp32 = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)
    assert 1e-5 < _max_rel(y, fp32) <= 2e-2


def _hub_coo(n, m, hub, seed):
    """A power-law graph with a ``hub``-edge row (row 7) and every fifth row
    empty; non-symmetric, so the transpose is another matrix."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([rng.zipf(1.5, m) % n, np.full(hub, 7)])
    cols = np.concatenate([rng.randint(0, n, m),
                           rng.choice(n, hub, replace=False)])
    keep = rows % 5 != 4
    a = sp.coo_matrix((rng.randn(int(keep.sum())).astype(np.float32),
                       (rows[keep], cols[keep])), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


def _resplit(op, limit):
    """``op`` with its long rows cut at ``limit`` edges instead."""
    return op._replace(
        split=coo_spmv.split_rows(op.row_ptr.cpu().numpy(), limit,
                                  device=op.device),
        split_t=coo_spmv.split_rows(op.row_ptr_t.cpu().numpy(), limit,
                                    device=op.device))


@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [1, 4, 7, 20, 40])
def test_k1_cuda_split_rows_forward_transpose_and_autograd(cuda_device, d,
                                                           bf16, limit,
                                                           monkeypatch):
    """The redesigned K1 on a hub graph with empty rows: wide loads at every
    width (several rows a warp at d = 1 and 4), long rows through the chunk
    kernels, forward, over the transpose CSR and through autograd, bit-equal
    on a second call."""
    n = 3001                                  # no multiple of 8 or 32
    a = _hub_coo(n, 40000, 2000, seed=d)
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    assert op.split.long_rows.numel() > 0 and int(np.diff(a.indptr).min()) == 0
    rng = np.random.RandomState(d + 50)
    x = torch.as_tensor(rng.randn(n, d).astype(np.float32),
                        device=cuda_device)
    g = torch.as_tensor(rng.randn(n, d).astype(np.float32),
                        device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", bf16)
    rounds = bf16 and d > 1
    counter = "BF16_LAUNCHES" if rounds else "LAUNCHES"
    before = getattr(coo_spmv, counter)
    xg = x.clone().requires_grad_()
    y = coo_spmv.coo_spmv(op, xg)
    (dx,) = torch.autograd.grad((y * g).sum(), xg)
    yt = coo_spmv.coo_spmv(op.transpose(), g)
    torch.cuda.synchronize()
    assert getattr(coo_spmv, counter) == before + 3
    ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, n, rounds)
    ref_t = coo_spmv.coo_spmv_plain(op.rows_t, op.cols_t, op.vals_t, g, n,
                                    rounds)
    assert _max_rel(y, ref) <= 1e-5
    assert _max_rel(dx, ref_t) <= 1e-5 and _max_rel(yt, ref_t) <= 1e-5
    assert torch.equal(dx, yt)
    assert not y[np.flatnonzero(np.diff(a.indptr) == 0)].any()
    assert torch.equal(y, coo_spmv.coo_spmv(op, x))   # repeatable


def _k1w_form(monkeypatch, form, d):
    """Set K1-w to its warp form ("rows": the crossover at 0) or leave the
    plan's own ("edges": the edge form up to the crossover); return the
    form that then runs at width d."""
    if form == "rows":
        monkeypatch.setattr(coo_mutual, "EDGE_MAX_WIDTH", 0)
    return "edges" if d <= coo_mutual.EDGE_MAX_WIDTH else "rows"


@pytest.mark.parametrize("form", ["rows", "edges"])
@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("convention", ["reference", "paper"])
@pytest.mark.parametrize("d", [1, 5, 20])
def test_k1w_cuda_forward_and_backward_match_plain(cuda_device, d, convention,
                                                   limit, form, monkeypatch):
    """K1-w on a non-symmetric graph with a hub row, a hub column and empty
    rows, both e/h orders (the convention's swap), in each form: the warp
    form with long rows of A and of Aᵀ through the chunk kernels and d = 5
    on 4-byte loads, and the plan's own (the edge form at d = 1 and 5, with
    carries for the long rows; the warp form at d = 20). Forward and both
    sides of the backward against the plain version, bit-equal on a second
    call; one launch forward, two backward, of the form that should run."""
    runs = _k1w_form(monkeypatch, form, d)
    n = 3001
    # a hub row (7) and a hub column (7, the transpose's hub row)
    a = abs(_hub_coo(n, 40000, 2000, seed=d)
            + _hub_coo(n, 2000, 600, seed=d + 1).T).tocsr()
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    assert op.split.long_rows.numel() > 0 and op.split_t.long_rows.numel() > 0
    rng = np.random.RandomState(d + 60)
    x = torch.as_tensor((rng.rand(n, d) * 3 + 0.2).astype(np.float32),
                        device=cuda_device)
    g = torch.as_tensor(rng.randn(n, d).astype(np.float32),
                        device=cuda_device)
    e, h = (0.1, 0.9) if convention == "reference" else (0.9, 0.1)

    def both(fn):
        xg = x.clone().requires_grad_()
        y = fn(op, xg, 5.0, e, h)
        (dx,) = torch.autograd.grad(y, xg, g)
        return y.detach(), dx

    before = (coo_mutual.LAUNCHES, coo_mutual.EDGE_LAUNCHES)
    y, dx = both(coo_mutual.coo_mutual_inter)
    torch.cuda.synchronize()
    assert coo_mutual.LAUNCHES == before[0] + 3
    assert coo_mutual.EDGE_LAUNCHES == before[1] + 3 * (runs == "edges")
    ref, dref = both(coo_mutual.coo_mutual_inter_plain)
    assert _max_rel(y, ref) <= 1e-5 and _max_rel(dx, dref) <= 1e-5
    assert not y[np.flatnonzero(np.diff(a.indptr) == 0)].any()
    y2, dx2 = both(coo_mutual.coo_mutual_inter)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)     # repeatable


@pytest.mark.parametrize("form", ["rows", "edges"])
def test_k1w_cuda_divides_a_zero_denominator_by_one(cuda_device, form,
                                                    monkeypatch):
    """With d = 0 and zero states the pair term's denominator is 0: the
    kernel divides by 1 there, as the plain version (``_safe_div``), in
    either form (the warp form; the plan's, the edge form at this d = 4)."""
    runs = _k1w_form(monkeypatch, form, 4)
    a, _ = _power_law_coo(500, 4000, seed=3, d=1)
    a.data = np.abs(a.data)
    op = from_scipy_coo(a, device=cuda_device)
    rng = np.random.RandomState(4)
    x = torch.as_tensor((rng.rand(500, 4) * (rng.rand(500, 4) < 0.5))
                        .astype(np.float32), device=cuda_device)
    before = coo_mutual.EDGE_LAUNCHES
    y = coo_mutual.coo_mutual_inter(op, x, 0.0, 0.9, 0.1)
    assert coo_mutual.EDGE_LAUNCHES == before + (runs == "edges")
    ref = coo_mutual.coo_mutual_inter_plain(op, x, 0.0, 0.9, 0.1)
    assert bool(torch.isfinite(y).all()) and _max_rel(y, ref) <= 1e-5


def _edge_form_graph(kind, d, seed):
    """A graph cut to K1-w's edge-form plan at width d (as
    ``tests/test_torch_mutual_plan.py::edge_form_graph``): ``empty_rows``,
    ``hub`` (a row of 3 CTAs' edges and 17 more) or ``straddle`` (rows
    across the first CTA boundary and across a warp boundary)."""
    plan = coo_mutual.mutual_plan(d, 0)
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
    elif kind == "straddle":
        for edge in (warp * 3, cta):
            ptr = np.concatenate([[0], np.cumsum(deg)])
            r = int(np.searchsorted(ptr, edge - 1, side="right")) - 1
            deg[r] += 5 * (ptr[r + 1] == edge)
    ptr = np.concatenate([[0], np.cumsum(deg)])
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in deg])
    vals = (rng.rand(ptr[-1]) + 0.1).astype(np.float32)
    return sp.csr_matrix((vals, cols, ptr), shape=(n, n))


def _k1w_both(op, x, g, coef, fn=None):
    """K1-w's forward and, through autograd, its backward."""
    fn = fn or coo_mutual.coo_mutual_inter
    xg = x.clone().requires_grad_()
    y = fn(op, xg, *coef)
    (dx,) = torch.autograd.grad(y, xg, g)
    return y.detach(), dx


@pytest.mark.parametrize("kind,transposed", [
    ("empty_rows", False), ("hub", False), ("hub", True),
    ("straddle", False)])
@pytest.mark.parametrize("convention", ["reference", "paper"])
@pytest.mark.parametrize("d", [1, 2])
def test_k1w_cuda_edge_form_matches_plain(cuda_device, d, convention, kind,
                                          transposed):
    """K1-w's edge form (the plan's at d = 1 and 2) on empty rows, a hub row
    longer than a CTA's range (and, transposed, a hub column: the backward's
    column side walks it as a row), rows across warp and CTA boundaries:
    forward and both sides of the backward against the plain version,
    bit-equal on a second call; one launch forward, two backward."""
    a = _edge_form_graph(kind, d, seed=d)
    a = a.T.tocsr() if transposed else a
    op = from_scipy_coo(a, device=cuda_device)
    rng = np.random.RandomState(d + 70)
    x = torch.as_tensor((rng.rand(a.shape[0], d) * 3 + 0.2)
                        .astype(np.float32), device=cuda_device)
    g = torch.as_tensor(rng.randn(a.shape[0], d).astype(np.float32),
                        device=cuda_device)
    coef = (5.0, 0.1, 0.9) if convention == "reference" else (5.0, 0.9, 0.1)
    before = (coo_mutual.LAUNCHES, coo_mutual.EDGE_LAUNCHES)
    y, dx = _k1w_both(op, x, g, coef)
    torch.cuda.synchronize()
    assert coo_mutual.LAUNCHES == before[0] + 3
    assert coo_mutual.EDGE_LAUNCHES == before[1] + 3     # the edge form ran
    ref, dref = _k1w_both(op, x, g, coef, coo_mutual.coo_mutual_inter_plain)
    assert _max_rel(y, ref) <= 1e-5 and _max_rel(dx, dref) <= 1e-5
    assert not y[np.flatnonzero(np.diff(a.indptr) == 0)].any()
    y2, dx2 = _k1w_both(op, x, g, coef)
    assert torch.equal(y, y2) and torch.equal(dx, dx2)     # repeatable


@pytest.mark.parametrize("d", range(1, coo_mutual.EDGE_MAX_WIDTH + 1))
def test_k1w_cuda_every_edge_width_matches_plain(cuda_device, d):
    """Every width the edge form is built for, on the hub graph with empty
    rows (carries: a row of 3 CTAs' edges) and on its transpose (no long
    row: each CTA reads on to the end of its last row): forward and
    backward against the plain version, bit-equal on a second call."""
    a = _edge_form_graph("hub", 1, seed=d)
    keep = np.ones(a.shape[0], np.float32)
    keep[::7] = 0                               # more empty rows
    a = (sp.diags(keep) @ a).tocsr()
    a.eliminate_zeros()
    for m in (a, a.T.tocsr()):
        op = from_scipy_coo(m, device=cuda_device)
        rng = np.random.RandomState(d * 10)
        x = torch.as_tensor((rng.rand(m.shape[0], d) * 3 + 0.2)
                            .astype(np.float32), device=cuda_device)
        g = torch.as_tensor(rng.randn(m.shape[0], d).astype(np.float32),
                            device=cuda_device)
        coef = (5.0, 0.1, 0.9)
        before = coo_mutual.EDGE_LAUNCHES
        y = coo_mutual.mutual_forward(op, x, *coef)
        dx = coo_mutual.mutual_backward(op, x, g, *coef)
        assert coo_mutual.EDGE_LAUNCHES == before + 3   # the edge form ran
        assert _max_rel(y, coo_mutual.mutual_forward_plain(op, x,
                                                           *coef)) <= 1e-5
        assert _max_rel(dx, coo_mutual.mutual_backward_plain(op, x, g,
                                                             *coef)) <= 1e-5
        assert torch.equal(y, coo_mutual.mutual_forward(op, x, *coef))
        assert torch.equal(dx, coo_mutual.mutual_backward(op, x, g, *coef))


@pytest.mark.parametrize("d", [1, 2])
def test_k1w_cuda_edge_form_edge_cases(cuda_device, d):
    """The edge form with a zero denominator (divided as 1), with columns
    and values off their 16-byte alignment (scalar loads), and on a graph
    without edges (zeros, and the column side adds nothing)."""
    a, _ = _power_law_coo(5000, 30000, seed=d, d=1)
    a.data = np.abs(a.data)
    op = from_scipy_coo(a, device=cuda_device)
    rng = np.random.RandomState(d + 4)
    x = torch.as_tensor((rng.rand(5000, d) * (rng.rand(5000, d) < 0.5))
                        .astype(np.float32), device=cuda_device)
    g = torch.as_tensor(rng.randn(5000, d).astype(np.float32),
                        device=cuda_device)
    coef = (0.0, 0.9, 0.1)
    before = coo_mutual.EDGE_LAUNCHES
    y, dx = _k1w_both(op, x, g, coef)
    assert coo_mutual.EDGE_LAUNCHES == before + 3        # the edge form ran
    ref, dref = _k1w_both(op, x, g, coef, coo_mutual.coo_mutual_inter_plain)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
    assert _max_rel(y, ref) <= 1e-5 and _max_rel(dx, dref) <= 1e-5

    def shifted(t):     # the same values one element past a 16-byte line
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t
        return buf[1:]

    off = op._replace(cols=shifted(op.cols), vals=shifted(op.vals),
                      cols_t=shifted(op.cols_t), vals_t=shifted(op.vals_t))
    assert off.cols.data_ptr() % 16 != 0
    y_off, dx_off = _k1w_both(off, x, g, (5.0, 0.1, 0.9))
    y_al, dx_al = _k1w_both(op, x, g, (5.0, 0.1, 0.9))
    assert torch.equal(y_off, y_al) and torch.equal(dx_off, dx_al)

    empty = from_scipy_coo(sp.csr_matrix((300, 300), dtype=np.float32),
                           device=cuda_device)
    xe = torch.rand(300, d, device=cuda_device) + 0.5
    ye, dxe = _k1w_both(empty, xe, torch.ones_like(xe), coef)
    assert not ye.any() and not dxe.any()


def test_mutualistic_drivers_on_cuda(cuda_device, tmp_path):
    """The scale driver's mutualistic ground truth on the card (K1-w at
    d = 1) within 1e-4 rel-L1 of the CPU's, and both mutualistic drivers
    training on the card."""
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.experiments.dynamics import build_parser, run

    truths = {}
    for platform in ("cpu", "gpu"):
        cache = str(tmp_path / f"gt_{platform}.npz")
        large_graph.main(["--n", "3000", "--dynamics", "mutualistic",
                          "--platform", platform, "--gt_only", "--gt_cache",
                          cache])
        truths[platform] = np.load(cache)["truth"]
    assert _rel_l1(torch.as_tensor(truths["gpu"]),
                   torch.as_tensor(truths["cpu"])) <= 1e-4
    kernels.reset_launch_counts()
    rec = large_graph.main(["--n", "3000", "--dynamics", "mutualistic",
                            "--iters", "2"])
    counts = kernels.launch_counts()
    assert counts["coo_mutual"] > 0 and counts["coo_spmv"] > 0
    # every K1-w call of the driver (d = 1) ran the edge form
    assert counts["coo_mutual_edges"] == counts["coo_mutual"]
    assert np.isfinite(rec["rel_loss_final"])
    out = run("mutualistic", build_parser("t").parse_args(
        ["--n", "36", "--time_tick", "8", "--niters", "2", "--test_freq",
         "2", "--method", "dopri5", "--max_steps", "32", "--sparse",
         "--sparse_format", "coo"]))
    assert out["device"] == "cuda:0" and np.isfinite(out["final"]["abs_error"])


@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d_sub", [8, 24, 40])
def test_k1fm_cuda_split_rows_forward_transpose_and_autograd(cuda_device,
                                                             d_sub, bf16,
                                                             limit,
                                                             monkeypatch):
    """The redesigned K1-fm (pack, gather, chunk kernels) on the hub graph."""
    n, d = 3001, d_sub - 3
    a = _hub_coo(n, 40000, 2000, seed=d_sub)
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    rng = np.random.RandomState(d_sub + 60)
    xT = torch.zeros(d_sub, n, device=cuda_device)
    xT[:d] = torch.as_tensor(rng.randn(d, n).astype(np.float32),
                             device=cuda_device)
    gT = torch.as_tensor(rng.randn(d_sub, n).astype(np.float32),
                         device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_WIDE", False)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", bf16)
    before = coo_spmv.T_LAUNCHES, coo_spmv.PACK_LAUNCHES
    xg = xT.clone().requires_grad_()
    y = coo_spmv.spmv_T(op, xg)
    (dx,) = torch.autograd.grad((y * gT).sum(), xg)
    yt = coo_spmv.spmv_T(op.transpose(), gT)
    torch.cuda.synchronize()
    assert (coo_spmv.T_LAUNCHES, coo_spmv.PACK_LAUNCHES) == (before[0] + 3,
                                                             before[1] + 3)
    plain = coo_spmv.coo_spmv_T_plain
    assert _max_rel(y, plain(op.rows, op.cols, op.vals, xT, n, bf16)) <= 1e-5
    ref_t = plain(op.rows_t, op.cols_t, op.vals_t, gT, n, bf16)
    assert _max_rel(dx, ref_t) <= 1e-5 and torch.equal(dx, yt)
    assert not y[d:].any()                          # zero pad rows stay zero
    assert not y[:, np.flatnonzero(np.diff(a.indptr) == 0)].any()
    assert torch.equal(y, coo_spmv.spmv_T(op, xT))  # repeatable


@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d_sub", [8, 24, 128])
def test_k5_cuda_hub_graph_forward_and_transposed(cuda_device, d_sub, bf16,
                                                  limit, monkeypatch):
    """K5 (``GATHER_WIDE``: a PyTorch copy of the table, then the shared
    gather with its chunk kernels) on the hub graph, forward, over the
    transpose CSR and through autograd, against its plain version;
    bit-equal on a second call."""
    n, d = 3001, d_sub - 3
    a = _hub_coo(n, 40000, 2000, seed=d_sub + 1)
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    assert op.split.long_rows.numel() > 0
    rng = np.random.RandomState(d_sub + 61)
    xT = torch.zeros(d_sub, n, device=cuda_device)
    xT[:d] = torch.as_tensor(rng.randn(d, n).astype(np.float32),
                             device=cuda_device)
    gT = torch.as_tensor(rng.randn(d_sub, n).astype(np.float32),
                         device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_WIDE", True)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", bf16)
    before = coo_spmv.WIDE_LAUNCHES, coo_spmv.T_LAUNCHES
    xg = xT.clone().requires_grad_()
    y = coo_spmv.spmv_T(op, xg)
    (dx,) = torch.autograd.grad((y * gT).sum(), xg)
    yt = coo_spmv.spmv_T(op.transpose(), gT)
    torch.cuda.synchronize()
    assert (coo_spmv.WIDE_LAUNCHES, coo_spmv.T_LAUNCHES) == (before[0] + 3,
                                                             before[1])
    plain = coo_spmv.coo_spmv_T_wide_plain
    assert _max_rel(y, plain(op.rows, op.cols, op.vals, xT, n, bf16)) <= 1e-5
    ref_t = plain(op.rows_t, op.cols_t, op.vals_t, gT, n, bf16)
    assert _max_rel(dx, ref_t) <= 1e-5 and _max_rel(yt, ref_t) <= 1e-5
    assert torch.equal(dx, yt)
    assert not y[d:].any()
    assert not y[:, np.flatnonzero(np.diff(a.indptr) == 0)].any()
    assert torch.equal(y, coo_spmv.spmv_T(op, xT))  # repeatable


def test_k5_cuda_refuses_d_sub_over_128(cuda_device, monkeypatch):
    a, _ = _power_law_coo(500, 4000, seed=5, d=1)
    op = from_scipy_coo(a, device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_WIDE", True)
    before = coo_spmv.WIDE_LAUNCHES
    with pytest.raises(ValueError, match="d_sub <= 128"):
        coo_spmv.spmv_T(op, torch.zeros(136, 500, device=cuda_device))
    assert coo_spmv.WIDE_LAUNCHES == before
    assert coo_spmv.spmv_T(op, torch.zeros(128, 500,
                                           device=cuda_device)).shape == (
        128, 500)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d_sub,n", [(8, 100), (24, 3001), (40, 64),
                                     (136, 4097)])
def test_pack_rows_cuda_is_exact(cuda_device, d_sub, n, bf16):
    xT = torch.as_tensor(np.random.RandomState(n).randn(d_sub, n)
                         .astype(np.float32), device=cuda_device)
    before = coo_spmv.PACK_LAUNCHES
    table = coo_spmv.pack_rows(xT, bf16)
    torch.cuda.synchronize()
    assert coo_spmv.PACK_LAUNCHES == before + 1
    assert table.shape == (n, d_sub) and table.is_contiguous()
    assert torch.equal(table, coo_spmv.pack_rows_plain(xT, bf16))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d", [4, 20, 40])
def test_spmv_T_cuda_matches_plain_forward_and_transpose(cuda_device, wide,
                                                         bf16, d,
                                                         monkeypatch):
    """K1-fm and K5 (fp32 and bf16) through autograd: the forward and the
    transpose product of the backward, against the plain versions."""
    a, x = _power_law_coo(3000, 40000, seed=d, d=d)
    op = from_scipy_coo(a, device=cuda_device)
    d_sub = coo_spmv.sublane_pad(d)
    xT = torch.zeros(d_sub, 3000, device=cuda_device)
    xT[:d] = torch.as_tensor(x.T, device=cuda_device)
    gT = torch.randn(d_sub, 3000, device=cuda_device)
    monkeypatch.setattr(coo_spmv, "GATHER_WIDE", wide)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", bf16)
    plain = (coo_spmv.coo_spmv_T_wide_plain if wide
             else coo_spmv.coo_spmv_T_plain)
    counter = "WIDE_LAUNCHES" if wide else "T_LAUNCHES"
    before = getattr(coo_spmv, counter)
    xg = xT.clone().requires_grad_()
    y = coo_spmv.spmv_T(op, xg)
    (dx,) = torch.autograd.grad((y * gT).sum(), xg)
    torch.cuda.synchronize()
    assert getattr(coo_spmv, counter) == before + 2
    assert _max_rel(y, plain(op.rows, op.cols, op.vals, xT, op.n, bf16)) <= 1e-5
    assert _max_rel(dx, plain(op.rows_t, op.cols_t, op.vals_t, gT, op.n,
                              bf16)) <= 1e-5
    assert not y[d:].any()                          # zero pad rows stay zero
    assert torch.equal(y, coo_spmv.spmv_T(op, xT))  # no atomics: repeatable


@pytest.mark.parametrize("n,d,R,E,case,pad", [
    pytest.param(20000, 20, 128, 2048, "hub", False, id="20000-20-128-2048"),
    pytest.param(3000, 7, 64, 512, "hub", False, id="3000-7-64-512"),
    pytest.param(1000, 40, 256, 300, "hub", False, id="1000-40-256-300"),
    pytest.param(20000, 20, 128, 2048, "hub", True, id="20000-20-padded"),
    pytest.param(5000, 1, 128, 2048, "hub", True, id="d1"),
    pytest.param(3000, 20, 256, 128, "hub", False, id="R256-E128"),
    pytest.param(3000, 20, 64, 301, "hub", False, id="E301-scalar-loads"),
    pytest.param(4000, 20, 128, 512, "empty_tiles", False, id="empty-tiles"),
    pytest.param(3000, 20, 128, 512, "three_slices", False,
                 id="row-over-3-slices")])
def test_sliced_tile_reduce_cuda_matches_plain_and_oracle(cuda_device, n, d,
                                                          R, E, case, pad):
    """P1a on the card: within 1e-5 of the plain version and of a float64
    oracle, bit-equal on a repeat; contribs of d rows (d = 20 or 7 leave the
    last group of 8 features part idle) or padded to whole sublanes (d = 1
    gives 8 rows), a hub row over many slices (or exactly three), tiles with
    no edge, and an E that takes 4-byte loads."""
    rng = np.random.RandomState(n + d)
    rows, cols, vals = _sliced_graph(rng, n, R, E, case)
    x = rng.rand(n, d).astype(np.float32)
    tiles = sparse_bench.pack_sliced_tiles(rows, cols, vals, n, R, E,
                                           device=cuda_device)
    d_sub = coo_spmv.sublane_pad(d) if pad else d
    contrib = torch.zeros((d_sub, tiles.cols.shape[0]), device=cuda_device)
    contrib[:d] = torch.as_tensor(x.T.copy(), device=cuda_device)[
        :, tiles.cols.long()]
    before = sparse_bench.SLICED_LAUNCHES
    out = sparse_bench.sliced_tile_reduce(tiles, contrib)
    ref = sparse_bench.sliced_tile_reduce_plain(tiles, contrib)
    torch.cuda.synchronize()
    assert sparse_bench.SLICED_LAUNCHES == before + 1
    assert _max_rel(out, ref) <= 1e-5
    assert torch.equal(out, sparse_bench.sliced_tile_reduce(tiles, contrib))
    oracle = np.zeros((n, d), np.float64)
    np.add.at(oracle, rows, vals[:, None].astype(np.float64) * x[cols])
    assert _max_rel(out[:d, :n].T.cpu(), torch.as_tensor(oracle)) <= 1e-5
    assert not out[:, n:].any() and not out[d:].any()


def _sliced_graph(rng, n, R, E, case):
    """Row-sorted edges (rows, cols, vals) for P1a: 11 a node with row 5 a
    3000-edge hub; or with every other tile empty; or with row 3 spanning
    exactly three slices of its tile."""
    rows = rng.randint(0, n, n * 11)
    if case == "hub":
        rows[:3000] = 5
    elif case == "empty_tiles":
        rows = rows[(rows // R) % 2 == 0]
    else:
        rows = rows[rows // R != 0]
        rows = np.concatenate([rows, np.full(2 * E + 10, 3)])
    rows = np.sort(rows).astype(np.int32)
    return (rows, rng.randint(0, n, rows.size).astype(np.int32),
            rng.rand(rows.size).astype(np.float32))


@pytest.mark.parametrize("m,k,rows", [(1024, 128, 512), (4096, 128, 2048),
                                      (77, 12, 1000)])
def test_row_gather_cuda_is_exact(cuda_device, m, k, rows):
    rng = np.random.RandomState(m)
    x = torch.as_tensor(rng.rand(m, k).astype(np.float32), device=cuda_device)
    idx = torch.as_tensor(rng.randint(0, m, rows).astype(np.int32),
                          device=cuda_device)
    before = sparse_bench.GATHER_LAUNCHES
    out = sparse_bench.row_gather(x, idx)
    torch.cuda.synchronize()
    assert sparse_bench.GATHER_LAUNCHES == before + 1
    assert torch.equal(out, x[idx.long()])


def test_cuda_kernels_backward_matches_plain(cuda_device):
    """K1ᵀ (K1 over the transpose CSR) and K2's backward on the card, against
    autograd of the plain versions on the same non-symmetric inputs."""
    a, x = _power_law_coo(3000, 40000, seed=3, d=20)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x, device=cuda_device).requires_grad_()
    g = torch.randn(3000, 20, device=cuda_device)
    before = coo_spmv.LAUNCHES
    (dx,) = torch.autograd.grad((coo_spmv.coo_spmv(op, x) * g).sum(), x)
    assert coo_spmv.LAUNCHES == before + 2        # forward and backward
    (ref,) = torch.autograd.grad((coo_spmv.coo_spmv_plain(
        op.rows, op.cols, op.vals, x, op.n) * g).sum(), x)
    assert _max_rel(dx, ref) <= 1e-5
    a, h, w, b = _fused_inputs(400, 20, seed=0, device=cuda_device)
    g = torch.randn(400, 20, device=cuda_device)
    ins = [t.clone().requires_grad_() for t in (h, w, b)]
    got = torch.autograd.grad((fused_rhs.fused_rhs(a, *ins) * g).sum(), ins)
    ins = [t.clone().requires_grad_() for t in (h, w, b)]
    ref = torch.autograd.grad((fused_rhs.fused_rhs_plain(a, *ins) * g).sum(),
                              ins)
    for x_, y_ in zip(got, ref):
        scale = float(y_.abs().max())
        assert torch.allclose(x_, y_, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("n,d,block,m,empty", [
    pytest.param(400, 20, 128, 400, False, id="400-20-128"),
    pytest.param(2000, 256, 128, 2000, False, id="2000-256-128"),
    pytest.param(257, 5, 128, 257, False, id="257-5-128"),
    pytest.param(300, 33, 48, 300, False, id="300-33-48"),
    pytest.param(400, 1, 128, 400, False, id="d1"),
    pytest.param(600, 1100, 128, 600, False, id="d1100-over-k_max"),
    pytest.param(200, 20, 9, 200, False, id="block9"),
    pytest.param(300, 20, 128, 500, False, id="rectangular-300x500"),
    pytest.param(500, 20, 128, 300, False, id="rectangular-500x300"),
    pytest.param(400, 20, 128, 400, True, id="empty-row-block")])
def test_k3_cuda_matches_plain_forward_and_backward(cuda_device, n, d, block,
                                                    m, empty):
    """K3 and K3 over Aᵀ (its backward) within 1e-5 of the plain version and
    2e-6 of the emulation of its split-TF32 product, bit-equal on a repeat;
    widths beyond one slab and K_MAX, other block sizes, rectangular A (and
    its transpose), a row block with no stored block."""
    rng = np.random.RandomState(n + d + m)
    a = sp.random(n, m, density=0.05, random_state=rng, format="lil")
    if empty:
        a[block:2 * block] = 0
    from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
    op = from_scipy_bsr_graph(a.tocsr(), block=block, device=cuda_device)
    x = torch.as_tensor(rng.randn(m, d).astype(np.float32),
                        device=cuda_device).requires_grad_()
    g = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda_device)
    before = bsr_spmm.SPMM_LAUNCHES
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, x)
    (dx,) = torch.autograd.grad((y * g).sum(), x)
    torch.cuda.synchronize()
    assert bsr_spmm.SPMM_LAUNCHES == before + 2
    for got, mat, v in ((y.detach(), op.fwd, x.detach()), (dx, op.bwd, g)):
        assert _max_rel(got, bsr_spmm.bsr_spmm_plain(mat, v)) <= 1e-5
        emu = bsr_spmm.bsr_spmm_split_plain(mat, v)
        assert float((got - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
    assert torch.equal(y, bsr_spmm.bsr_spmm(op.fwd, op.bwd, x))  # repeatable
    assert torch.equal(dx, bsr_spmm.bsr_spmm(op.bwd, op.fwd, g))
    if empty:
        assert not y[block:2 * block].any()


@pytest.mark.parametrize("n,d,block", [(400, 20, 128), (2000, 512, 128),
                                       (300, 1024, 128), (300, 33, 48),
                                       (257, 5, 9)])
def test_k4_cuda_repeats_and_matches_split_emulation(cuda_device, n, d, block):
    """K4 bit-equal on a repeat, within 2e-6 of the emulation of its split
    product, and not a one-pass TF32 product; block sizes other than 128 and
    an empty row block included."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
    rng = np.random.RandomState(n + d)
    a = sp.random(n, n, density=0.05, random_state=rng, format="lil")
    a[:block] = 0                                  # an empty row block
    op = from_scipy_bsr_graph(a.tocsr(), block=block, device=cuda_device)
    x = torch.as_tensor(rng.rand(n, d).astype(np.float32), device=cuda_device)
    weight = torch.as_tensor((rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
                             device=cuda_device)
    b = torch.as_tensor(0.1 * rng.randn(d).astype(np.float32),
                        device=cuda_device)
    y = bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, weight.t(), b)
    assert torch.equal(y, bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x,
                                                 weight.t(), b))
    assert torch.equal(y, bsr_spmm.bsr_fused_rhs(
        op.fwd, op.bwd, x, weight.t().contiguous(), b))
    emu = bsr_spmm.bsr_fused_rhs_split_plain(op.fwd, x, weight.t(), b)
    scale = float(emu.abs().max())
    assert float((y - emu).abs().max()) <= 2e-6 * scale
    assert _max_rel(y, bsr_spmm.bsr_fused_rhs_plain(op.fwd, x, weight.t(),
                                                    b)) <= 1e-5
    one_pass = bsr_spmm.bsr_fused_rhs_split_plain(op.fwd, x, weight.t(), b,
                                                  passes=1)
    if d >= 20:
        assert float((y - one_pass).abs().max()) > 1e-5 * scale


@pytest.mark.parametrize("n,d", [(400, 20), (2000, 256), (300, 513),
                                 (2000, 512), (300, 1024)])
def test_k4_cuda_matches_plain_forward_and_backward(cuda_device, n, d):
    rng = np.random.RandomState(d)
    a = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    op = as_operator(a, sparse=True, format="bsr", device=cuda_device)
    x = torch.as_tensor(rng.rand(n, d).astype(np.float32), device=cuda_device)
    weight = torch.as_tensor((rng.randn(d, d) / np.sqrt(d)).astype(np.float32),
                             device=cuda_device)
    b = torch.as_tensor(0.1 * rng.randn(d).astype(np.float32),
                        device=cuda_device)
    g = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda_device)
    # no cotangent where the forward's bound (1e-5·max) leaves relu's mask
    # open: there a kernel and its plain version may differ, and the
    # derivative jumps. That is at most one element in 10,000.
    z = bsr_spmm.bsr_spmm_plain(op.fwd, x) @ weight.t() + b
    open_mask = z.abs() <= 1e-5 * z.abs().max()
    assert int(open_mask.sum()) <= max(2, 1e-4 * open_mask.numel())
    g = g.masked_fill(open_mask, 0.0)
    ins = [t.clone().requires_grad_() for t in (x, weight, b)]
    before = bsr_spmm.FUSED_LAUNCHES
    out = bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, ins[0], ins[1].t(), ins[2])
    got = torch.autograd.grad((out * g).sum(), ins)
    torch.cuda.synchronize()
    assert bsr_spmm.FUSED_LAUNCHES == before + 1
    ref_ins = [t.clone().requires_grad_() for t in (x, weight, b)]
    ref = bsr_spmm.bsr_fused_rhs_plain(op.fwd, ref_ins[0], ref_ins[1].t(),
                                       ref_ins[2])
    ref_g = torch.autograd.grad((ref * g).sum(), ref_ins)
    assert _max_rel(out, ref) <= 1e-5
    for x_, y_ in zip(got, ref_g):
        assert _max_rel(x_, y_) <= 1e-5


def test_k3_cuda_refuses_a_slab_off_the_n8_tiles(cuda_device):
    """The C entry takes a slab of all of d or of whole n8 tiles (each slab
    starts on a 16-byte boundary for the vector copies) and refuses another
    with cudaErrorInvalidValue, before launching."""
    from ndcn_tpu_torch.kernels import build
    rng = np.random.RandomState(0)
    a = bsr_spmm.from_scipy_bsr(sp.random(400, 400, density=0.05,
                                          random_state=rng, format="csr"),
                                device=cuda_device)
    x = torch.as_tensor(rng.randn(400, 20).astype(np.float32),
                        device=cuda_device)
    ref = bsr_spmm.bsr_spmm_plain(a, x)
    lib = build.load()
    for slab, rc_want in ((20, 0), (16, 0), (8, 0), (12, 1), (4, 1)):
        p = bsr_spmm.spmm_plan_for(a.n_row_blocks, a.block, 20, slab).panel
        y = torch.zeros_like(ref)
        rc = lib.ndcn_bsr_spmm_f32(
            a.row_ptr.data_ptr(), a.block_cols.data_ptr(),
            a.blocks.data_ptr(), x.data_ptr(), y.data_ptr(), a.n_row_blocks,
            a.block, a.n_rows, a.n_cols, 20, slab, p.rows, p.wn, p.bk,
            p.smem_bytes, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == rc_want, slab
        if rc == 0:
            assert _max_rel(y, ref) <= 1e-5
        else:
            assert not y.any()


def _scale_one_rhs_call(monkeypatch, call, scale):
    """Let RHS evaluation number ``call`` (from 0) of the next
    ``ndcn_forward`` return ``scale`` times its value."""
    from ndcn_tpu_torch.models import ndcn as ndcn_module
    plain, seen = ndcn_module.ode_func, [0]

    def scaled(*args, **kwargs):
        y = plain(*args, **kwargs)
        seen[0] += 1
        return y * scale if seen[0] - 1 == call else y

    monkeypatch.setattr(ndcn_module, "ode_func", scaled)


def _rel_l1(got, want):
    return float((got - want).abs().sum() / want.abs().sum())


@pytest.mark.parametrize("weights", ["fresh", "fixture"])
@pytest.mark.parametrize("fmt,fused", [("dense", "auto"), ("coo", False),
                                       ("bsr", False), ("bsr", True)])
def test_train_step_gradients_on_cuda_match_cpu(cuda_device, monkeypatch, fmt,
                                                fused, weights):
    """One train step on grid400 on the card against the CPU, from freshly
    initialised weights (where ``experiments.heat`` starts) and from the
    ``ndcn_grads_grid400`` fixture's.

    At the fresh weights the loss is not differentiable where it is
    evaluated: in RHS evaluation 5 (stage 5 of the first step) one relu
    input, node 171 unit 5, is -2e-8 beside max|z| = 0.6, and the gradient
    through the first step's error ratio (2.8e-9, so the growth factor's
    derivative is large) differs by 4.0e-3 rel-L1 between the two sides
    (``tests/test_torch_train.py::test_fresh_weight_gradients_jump_at_a_relu_kink``
    shows the same jump in the JAX package). Which side an implementation
    lands on is decided by the last bit of its RHS, so the card's gradients
    are held to 1e-3 of the CPU's on ONE side of the kink: the CPU's own, or
    the CPU's with RHS evaluation 2 scaled by one ulp up or down, which
    moves that input across zero and nothing else. The two sides are held
    to the measured jump, so no other difference can hide there. At the
    fixture's weights there is one CPU gradient, and the fixture's own is
    held too."""
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    if weights == "fresh":
        vt = np.linspace(0.0, 2.0, 10).astype(np.float32)
        x0 = np.random.RandomState(0).uniform(0.0, 25.0, (400, 1)) \
            .astype(np.float32)
        target = torch.as_tensor(np.random.RandomState(1).rand(10, 400, 1)
                                 .astype(np.float32))
        sides = (None, 1.0 - 1e-7, 1.0 + 1e-7)
    else:
        gx = dict(np.load(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "fixtures",
            "ndcn_grads_grid400.npz")))
        tree = {name: {"w": gx[f"{name}_w"].T, "b": gx[f"{name}_b"]}
                for name in ("enc1", "enc2", "wt", "dec")}
        vt, x0 = gx["t"], gx["x0"]
        target = torch.as_tensor(gx["target"].T[..., None])
        sides = (None,)

    def train_step(dev, scale=None):
        model = (init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                           device=dev) if weights == "fresh"
                 else params_from_jax(tree, device=dev))
        op = as_operator(mat, sparse=fmt != "dense", format=fmt, device=dev)
        with monkeypatch.context() as patch:
            if scale is not None:
                _scale_one_rhs_call(patch, 2, scale)
            out, stats = ndcn_forward(model, op, vt,
                                      torch.as_tensor(x0, device=dev),
                                      rtol=0.01, atol=0.001, method="dopri5",
                                      fused=fused)
        (out - target.to(dev)).abs().mean().backward()
        assert stats.success and stats.nfe == 20
        return {n: p.grad.cpu() for n, p in model.named_parameters()}

    def flat(grads):
        return torch.cat([v.flatten() for v in grads.values()])

    gpu = train_step(cuda_device)
    cpu = [flat(train_step("cpu", scale)) for scale in sides]
    for other in cpu[1:]:       # the same side, or the measured jump away
        gap = _rel_l1(other, cpu[0])
        assert gap <= 1e-5 or 3.9e-3 <= gap <= 4.1e-3
    assert min(_rel_l1(flat(gpu), side) for side in cpu) <= 1e-3
    if weights == "fixture":
        for name in ("enc1", "enc2", "wt", "dec"):
            for leaf, key in (("weight", "w"), ("bias", "b")):
                want = torch.as_tensor(gx[f"g_{name}_{key}_backprop"])
                assert _rel_l1(gpu[f"{name}.{leaf}"], want) <= 1e-3


def test_host_loop_block_read_on_cuda_matches_one_read_an_observation(
        cuda_device, monkeypatch):
    """The host loop's read of a step's observations in one block (the
    step's dense output read out once) against the read of one observation
    at a time kept in ``tests/test_torch_observe.py``, on the card, in a
    200k feature-major NDCN train solve (heat1m's path: K1-fm, the
    decoder's readout): trajectory bit-equal, stats equal, gradients within
    that file's float32 bound."""
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.ode import adaptive
    from ndcn_tpu_torch.train.sampling import sample_times
    from test_torch_observe import (GRAD_BOUND, _grads, _rel,
                                    solve_per_observation)

    n = 200_000
    lap = operators.normalized_laplacian_sparse(build_sparse_graph(n, 10, 0))
    op = as_operator(lap, sparse=True, format="coo", device=cuda_device)
    splits = sample_times(5.0, 40, "irregular", seed=0)
    vt = splits.t[splits.id_train]
    x0 = torch.as_tensor(np.random.RandomState(0).uniform(
        0.0, 25.0, (n, 1)).astype(np.float32), device=cuda_device)
    runs = []
    for solve in (adaptive.solve, solve_per_observation):
        monkeypatch.setattr(adaptive, "solve", solve)
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=cuda_device)
        x = x0.clone().requires_grad_()
        out, stats = ndcn_forward(model, op, vt, x, rtol=0.01, atol=0.001,
                                  method="dopri5", layout="feature_major")
        runs.append((out, stats, _grads(out, (*model.parameters(), x))))
    (out, stats, grads), (ref, ref_stats, ref_grads) = runs
    assert out.shape == (len(vt), n, 1) and stats.success
    assert torch.equal(out, ref) and stats == ref_stats
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= GRAD_BOUND[torch.float32]


@pytest.mark.parametrize("fmt", ["dense", "coo"])
def test_serving_on_cuda_matches_cpu(cuda_device, fmt):
    if fmt == "dense":
        mat = operators.normalized_laplacian(generators.build_network("grid", 400))
    else:
        mat = operators.normalized_laplacian_sparse(
            generators.build_sparse_graph(5000, 10, seed=0))
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1)
    vt = np.linspace(0.0, 2.0, 10).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (mat.shape[0], 1))
    kw = dict(rtol=0.01, atol=0.001, method="dopri5", fused="auto")
    out_cpu, ok_cpu = make_server(model, as_operator(mat, sparse=fmt == "coo"),
                                  vt, **kw)(x0)
    kernels.reset_launch_counts()
    out, ok = make_server(model.to(cuda_device),
                          as_operator(mat, sparse=fmt == "coo",
                                      device=cuda_device), vt, **kw)(x0)
    launched = kernels.launch_counts()["fused_rhs" if fmt == "dense"
                                       else "coo_spmv"]
    assert ok and ok_cpu and launched > 0
    rel = float((out.cpu() - out_cpu).abs().mean() / out_cpu.abs().mean())
    assert rel <= 1e-4


def _grid400_fixture(name):
    f = dict(np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "fixtures", f"{name}.npz")))
    tree = {n: {"w": f[f"{n}_w"].T, "b": f[f"{n}_b"]}
            for n in ("enc1", "enc2", "wt", "dec")}
    return f, tree, operators.normalized_laplacian(
        generators.build_network("grid", 400))


@pytest.mark.parametrize("fmt,fused,needed", [
    ("dense", "auto", ("fused_rhs",)), ("coo", False, ("coo_spmv",)),
    ("bsr", True, ("bsr_spmm", "bsr_fused_rhs"))])
def test_adjoint_gradients_on_cuda_meet_the_fixture(cuda_device, fmt, fused,
                                                    needed):
    """The continuous adjoint on grid400 at the ``ndcn_grads_grid400``
    weights, on the card: the forward through K2 / K1 / K4, the VJPs of the
    backward solve through K2's backward products / K1 over the transpose
    CSR / K3 over Aᵀ. Loss within 1e-4 and gradients within 1e-3 of the
    fixture's adjoint half, and within 1e-3 of the same step on the CPU."""
    f, tree, lap = _grid400_fixture("ndcn_grads_grid400")
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    target = torch.as_tensor(f["target"].T[..., None])

    def step(dev):
        model = params_from_jax(tree, device=dev)
        op = as_operator(mat, sparse=fmt != "dense", format=fmt, device=dev)
        out, stats = ndcn_forward(model, op, f["t"],
                                  torch.as_tensor(f["x0"], device=dev),
                                  rtol=0.01, atol=0.001, method="dopri5",
                                  fused=fused, adjoint=True, max_steps=64)
        loss = (out - target.to(dev)).abs().mean()
        loss.backward()
        assert stats.success and stats.nfe == 20
        return float(loss.detach()), {n: p.grad.cpu() for n, p in
                             model.named_parameters()}

    kernels.reset_launch_counts()
    loss, grads = step(cuda_device)
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in needed), counts
    _, cpu = step("cpu")
    ref = float(f["loss_adjoint"])
    assert abs(loss - ref) <= 1e-4 * abs(ref)
    for name in ("enc1", "enc2", "wt", "dec"):
        for leaf, key in (("weight", "w"), ("bias", "b")):
            got = grads[f"{name}.{leaf}"]
            assert torch.isfinite(got).all()
            want = torch.as_tensor(f[f"g_{name}_{key}_adjoint"])
            assert _rel_l1(got, want) <= 1e-3
            assert _rel_l1(got, cpu[f"{name}.{leaf}"]) <= 1e-3


@pytest.mark.parametrize("method", ["tsit5", "adams", "fixed_adams",
                                    "explicit_adams"])
def test_new_methods_serve_on_cuda_match_cpu(cuda_device, method):
    """grid400 dense, fused='auto' (K2), at the oracle fixture's weights:
    the card's trajectory within 1e-4 rel-L1 of the CPU's, or within twice
    the CPU's own float32-vs-float64 distance where that is larger
    (explicit_adams at order 11 is near its stability limit here: the
    trajectory grows from 0.2 to ~4e3 and the CPU alone parts from its
    float64 solve by 1.0e-4), NFE within 2 % (the adaptive methods' accept
    decisions sit on float32 sums the card orders differently)."""
    f, tree, lap = _grid400_fixture("ndcn_forward_grid400")
    kw = dict(rtol=0.01, atol=0.001, method=method, fused="auto")
    cpu = make_server(params_from_jax(tree), as_operator(lap), f["t"], **kw)
    out_cpu, ok_cpu = cpu(f["x0"])
    kernels.reset_launch_counts()
    gpu = make_server(params_from_jax(tree, device=cuda_device),
                      as_operator(lap, device=cuda_device), f["t"], **kw)
    out, ok = gpu(f["x0"])
    assert ok and ok_cpu and kernels.launch_counts()["fused_rhs"] > 0
    assert abs(gpu.last_stats.nfe - cpu.last_stats.nfe) <= \
        0.02 * cpu.last_stats.nfe
    model64 = params_from_jax(tree).double()
    out64, _ = ndcn_forward(model64, DenseGraph(torch.as_tensor(
        lap, dtype=torch.float64)), f["t"], torch.as_tensor(
            f["x0"], dtype=torch.float64), nondiff=True,
        **dict(kw, fused=False))
    bar = max(1e-4, 2 * _rel_l1(out_cpu.double(), out64))
    assert _rel_l1(out.cpu(), out_cpu) <= bar


# ---------------------------------------------------- the citation graphs


@pytest.fixture(scope="module")
def cora_operator():
    from ndcn_tpu_torch.data import load_planetoid
    return load_planetoid("cora", alpha=0.5, data_dir=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"))


@pytest.mark.parametrize("d", [6, 7, 16, 1433])
def test_k1_cuda_at_the_citation_widths(cuda_device, cora_operator, d):
    """K1 and K1ᵀ (over the transpose CSR, and through autograd) on cora's
    operator at the classes' widths (7; citeseer's 6), the hidden width and
    the raw features' 1433 (4-byte loads, rows of 45 lane segments): within
    1e-5 of the plain version, two calls bit-equal."""
    op = from_scipy_coo(cora_operator.operator, device=cuda_device)
    rng = np.random.RandomState(d)
    x = torch.as_tensor(rng.randn(op.n, d).astype(np.float32),
                        device=cuda_device).requires_grad_()
    g = torch.as_tensor(rng.randn(op.n, d).astype(np.float32),
                        device=cuda_device)
    before = coo_spmv.LAUNCHES
    y = coo_spmv.coo_spmv(op, x)
    (dx,) = torch.autograd.grad((y * g).sum(), x)
    torch.cuda.synchronize()
    assert coo_spmv.LAUNCHES == before + 2
    t = op.transpose()
    for got, o, v in ((y.detach(), op, x.detach()), (dx, t, g)):
        assert _max_rel(got, coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals,
                                                     v, o.n)) <= 1e-5
        assert torch.equal(got, coo_spmv.coo_spmv(o, v))


@pytest.mark.parametrize("d", [7, 16, 1433])
def test_k3_cuda_at_the_citation_widths(cuda_device, cora_operator, d):
    """K3 and K3ᵀ on cora's BSR operator (22 × 22 row blocks) at 7 (a slab
    of 7 columns), 16 and 1433 (slabs of 120, the last 113): within 1e-5 of
    the plain version and 2e-6 of the emulation of the split product,
    bit-equal on a repeat."""
    op = as_operator(cora_operator.operator, sparse=True, format="bsr",
                     device=cuda_device)
    rng = np.random.RandomState(d)
    x = torch.as_tensor(rng.randn(op.n, d).astype(np.float32),
                        device=cuda_device).requires_grad_()
    g = torch.as_tensor(rng.randn(op.n, d).astype(np.float32),
                        device=cuda_device)
    before = bsr_spmm.SPMM_LAUNCHES
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, x)
    (dx,) = torch.autograd.grad((y * g).sum(), x)
    torch.cuda.synchronize()
    assert bsr_spmm.SPMM_LAUNCHES == before + 2
    for got, mat, at, v in ((y.detach(), op.fwd, op.bwd, x.detach()),
                            (dx, op.bwd, op.fwd, g)):
        assert _max_rel(got, bsr_spmm.bsr_spmm_plain(mat, v)) <= 1e-5
        emu = bsr_spmm.bsr_spmm_split_plain(mat, v)
        assert float((got - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
        assert torch.equal(got, bsr_spmm.bsr_spmm(mat, at, v))


@pytest.mark.parametrize("model_name,fmt,needed", [
    ("GCN", "coo", "coo_spmv"), ("GCN", "bsr", "bsr_spmm"),
    ("differential_gcn", "dense", None),
    ("differential_gcn", "coo", "coo_spmv"),
    ("differential_gcn", "bsr", "bsr_spmm")])
def test_classification_train_step_on_cuda_matches_cpu(cuda_device,
                                                       cora_operator,
                                                       model_name, fmt,
                                                       needed):
    """One cora train step (weights from CPU generator seed 0, dropout 0,
    rtol = atol = 0.1) on the card against the CPU: the loss within 1e-4,
    every gradient within 1e-3 rel-L1, the NFE equal."""
    from ndcn_tpu_torch.models.gcn_zoo import GCN
    from ndcn_tpu_torch.train.losses import cross_entropy

    data = cora_operator
    vt = np.linspace(0, 2.0, 5).astype(np.float32)

    def step(dev):
        g = torch.Generator().manual_seed(0)
        if model_name == "GCN":
            model = GCN(1433, 16, 7, generator=g).to(dev)
        else:
            model = init_ndcn(g, 1433, 16, 7, encoder_layers=1, device=dev)
        op = as_operator(data.operator, sparse=fmt != "dense", format=fmt,
                         device=dev)
        x = torch.as_tensor(data.features, device=dev)
        idx = torch.as_tensor(data.idx_train, device=dev).long()
        nfe = None
        if model_name == "GCN":
            logits = model(op, x)
        else:
            logits, stats = ndcn_forward(model, op, vt, x, rtol=0.1,
                                         atol=0.1, terminal=True,
                                         max_steps=64)
            assert stats.success
            nfe = stats.nfe
        loss = cross_entropy(logits[idx], torch.as_tensor(
            data.labels, device=dev)[idx])
        loss.backward()
        return (float(loss), nfe,
                {n: p.grad.cpu() for n, p in model.named_parameters()})

    kernels.reset_launch_counts()
    loss_gpu, nfe_gpu, grads_gpu = step(cuda_device)
    torch.cuda.synchronize()
    if needed is not None:
        assert kernels.launch_counts()[needed] > 0
    loss_cpu, nfe_cpu, grads_cpu = step("cpu")
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    assert nfe_gpu == nfe_cpu
    for name, want in grads_cpu.items():
        assert _rel_l1(grads_gpu[name], want) <= 1e-3, name


# ------------------------------------------- the temporal-GNN baselines


@pytest.fixture(scope="module")
def heat_grid400():
    """The heat driver's data at its defaults (grid400, T 5, tick 100,
    irregular, seed 0): the Kipf operator and the train grid's truth."""
    from ndcn_tpu_torch.experiments.dynamics import ground_truth
    from ndcn_tpu_torch.train.sampling import sample_times

    adj = generators.build_network("grid", 400)
    splits = sample_times(5.0, 100, "irregular", seed=0)
    x0 = generators.grid_block_initial_value(20).astype(np.float32)
    sol, _ = ground_truth("heat", as_operator(operators.laplacian_dense(adj)),
                          torch.as_tensor(x0), splits.t)
    return dict(kipf=operators.zipf_smoothing(adj),
                y_train=sol[..., 0].T[:, splits.id_train].contiguous())


@pytest.mark.parametrize("fmt", ["coo", "bsr"])
def test_k1_and_k3_cuda_at_the_temporal_width(cuda_device, heat_grid400,
                                              fmt):
    """K1 / K1ᵀ and K3 / K3ᵀ on the grid400 Kipf operator at d = 5, the
    temporal baselines' graph width (K1: 4-byte loads, one edge in flight;
    K3: one slab of 5 in 16-row tiles): within 1e-5 of the plain version
    (K3 also 2e-6 of its split emulation), bit-equal on a repeat."""
    op = as_operator(heat_grid400["kipf"], sparse=True, format=fmt,
                     device=cuda_device)
    rng = np.random.RandomState(5)
    x = torch.as_tensor(rng.randn(400, 5).astype(np.float32),
                        device=cuda_device)
    g = torch.as_tensor(rng.randn(400, 5).astype(np.float32),
                        device=cuda_device)
    if fmt == "coo":
        cases = [(lambda v, o=o: coo_spmv.coo_spmv(o, v),
                  lambda v, o=o: coo_spmv.coo_spmv_plain(o.rows, o.cols,
                                                         o.vals, v, o.n),
                  None, v)
                 for o, v in ((op, x), (op.transpose(), g))]
    else:
        cases = [(lambda v, m=m, t=t: bsr_spmm.bsr_spmm(m, t, v),
                  lambda v, m=m: bsr_spmm.bsr_spmm_plain(m, v),
                  lambda v, m=m: bsr_spmm.bsr_spmm_split_plain(m, v), v)
                 for m, t, v in ((op.fwd, op.bwd, x), (op.bwd, op.fwd, g))]
    for kern, plain, emu, v in cases:
        y = kern(v)
        assert _max_rel(y, plain(v)) <= 1e-5
        if emu is not None:
            e = emu(v)
            assert float((y - e).abs().max()) <= 2e-6 * float(e.abs().max())
        assert torch.equal(y, kern(v))


@pytest.mark.parametrize("rnn_type,fmt,needed", [
    ("lstm", "coo", "coo_spmv"), ("gru", "bsr", "bsr_spmm"),
    ("rnn", "dense", None)])
def test_temporal_train_step_on_cuda_matches_cpu(cuda_device, heat_grid400,
                                                 rnn_type, fmt, needed):
    """One train step of the temporal baseline (weights from CPU generator
    seed 0; one step ahead over the 80 train points, so 79 graph products
    forward and 79 transposed) on the card against the CPU: the loss within
    1e-4, every gradient within 1e-3 rel-L1, 158 launches of the sparse
    kernel."""
    from ndcn_tpu_torch.models import init_temporal_gcn, temporal_gcn_forward
    from ndcn_tpu_torch.train.losses import l1_loss

    def step(dev):
        model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, 400,
                                  10, rnn_type, device=dev)
        op = as_operator(heat_grid400["kipf"], sparse=fmt != "dense",
                         format=fmt, device=dev)
        y = heat_grid400["y_train"].to(dev)
        loss = l1_loss(temporal_gcn_forward(model, op, y[:, :-1], rnn_type),
                       y[:, 1:])
        loss.backward()
        return loss.item(), {n: p.grad.cpu()
                             for n, p in model.named_parameters()}

    kernels.reset_launch_counts()
    loss_gpu, grads_gpu = step(cuda_device)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if needed is not None:
        assert counts[needed] == 2 * 79
    assert counts["coo_spmv"] + counts["bsr_spmm"] == (0 if needed is None
                                                       else 2 * 79)
    loss_cpu, grads_cpu = step("cpu")
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for name, want in grads_cpu.items():
        assert _rel_l1(grads_gpu[name], want) <= 1e-3, name


# ---------------------------------------------------------------- replicas


def _replica_x(rng, r, n, d, device):
    return torch.as_tensor(rng.randn(r, n, d).astype(np.float32),
                           device=device)


@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("d", [1, 7, 20])
def test_batched_k1_cuda_matches_plain_and_solo_launches(cuda_device, d, r,
                                                         limit):
    """K1's batched form (R replicas' X against one A, one launch) within
    1e-5 of the plain version, forward and through autograd (K1 batched over
    the transpose), and each replica bit-equal to its own one-replica
    launch; a hub graph with empty rows, its long rows through the chunk
    kernels at both limits."""
    n = 3001
    a = _hub_coo(n, 40000, 2000, seed=d)
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    rng = np.random.RandomState(d + r)
    x = _replica_x(rng, r, n, d, cuda_device)
    g = _replica_x(rng, r, n, d, cuda_device)
    before = (coo_spmv.BATCHED_LAUNCHES, coo_spmv.LAUNCHES)
    xg = x.clone().requires_grad_()
    y = coo_spmv.coo_spmv(op, xg)
    (dx,) = torch.autograd.grad((y * g).sum(), xg)
    torch.cuda.synchronize()
    assert (coo_spmv.BATCHED_LAUNCHES, coo_spmv.LAUNCHES) == (
        before[0] + 2, before[1])
    assert _max_rel(y, coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x,
                                               n)) <= 1e-5
    assert _max_rel(dx, coo_spmv.coo_spmv_plain(op.rows_t, op.cols_t,
                                                op.vals_t, g, n)) <= 1e-5
    for i in range(r):
        assert torch.equal(y[i], coo_spmv.coo_spmv(op, x[i].contiguous()))
        assert torch.equal(dx[i], coo_spmv.coo_spmv(op.transpose(),
                                                    g[i].contiguous()))
    assert torch.equal(y, coo_spmv.coo_spmv(op, x))    # repeatable


def _replica_weights(rng, r, k, device):
    """R nn.Linear-like weights (R, k, k) and the transposed views K2 / K4
    take, and biases (R, k)."""
    weight = torch.as_tensor((rng.randn(r, k, k) / np.sqrt(k))
                             .astype(np.float32), device=device)
    b = torch.as_tensor((0.1 * rng.randn(r, k)).astype(np.float32),
                        device=device)
    return weight, b


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("n,k", [(400, 20), (275, 13), (64, 300)])
def test_batched_k2_cuda_matches_plain_and_solo_launches(cuda_device, n, k,
                                                         r):
    """K2's batched form (own W, b per replica, one shared A) within K2's
    bounds of the plain version and its split emulation, its backward
    against autograd of the plain version, and each replica bit-equal to
    its own one-replica launch."""
    rng = np.random.RandomState(n + k + r)
    a = torch.as_tensor(rng.rand(n, n).astype(np.float32), device=cuda_device)
    h = torch.as_tensor(rng.rand(r, n, k).astype(np.float32),
                        device=cuda_device)
    weight, b = _replica_weights(rng, r, k, cuda_device)
    w = weight.transpose(-1, -2)
    before = fused_rhs.BATCHED_LAUNCHES
    y = fused_rhs.fused_rhs(a, h, w, b)
    torch.cuda.synchronize()
    assert fused_rhs.BATCHED_LAUNCHES == before + 1
    ref = fused_rhs.fused_rhs_plain(a, h, w, b)
    torch.testing.assert_close(y, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    emu = fused_rhs.fused_rhs_split_plain(a, h, w, b)
    assert float((y - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
    for i in range(r):
        assert torch.equal(y[i], fused_rhs.fused_rhs(a, h[i], w[i], b[i]))
    # no cotangent where relu's input is within the forward's bound of 0
    z = (a @ h) @ w + b.unsqueeze(-2)
    g = torch.as_tensor(rng.randn(r, n, k).astype(np.float32),
                        device=cuda_device).masked_fill(
        z.abs() <= 1e-5 * z.abs().max(), 0.0)
    ins = [t.clone().requires_grad_() for t in (h, weight, b)]
    out = fused_rhs.fused_rhs(a, ins[0], ins[1].transpose(-1, -2), ins[2])
    got = torch.autograd.grad((out * g).sum(), ins)
    ref_ins = [t.clone().requires_grad_() for t in (h, weight, b)]
    ref_out = fused_rhs.fused_rhs_plain(a, ref_ins[0],
                                        ref_ins[1].transpose(-1, -2),
                                        ref_ins[2])
    want = torch.autograd.grad((ref_out * g).sum(), ref_ins)
    for x_, y_ in zip(got, want):
        torch.testing.assert_close(x_, y_, rtol=1e-5,
                                   atol=1e-5 * float(y_.abs().max()))


@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("n,d", [(400, 20), (2000, 256), (300, 7)])
def test_batched_k3_k4_cuda_match_plain_and_solo_launches(cuda_device, n, d,
                                                          r):
    """K3's and K4's batched forms (one launch for R replicas) within 1e-5
    of their plain versions and 2e-6 of their split emulations, forward and
    through autograd, and each replica bit-equal to its own launch."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
    rng = np.random.RandomState(n + d + r)
    a = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    op = from_scipy_bsr_graph(a, device=cuda_device)
    x = torch.as_tensor(rng.rand(r, n, d).astype(np.float32),
                        device=cuda_device)
    g = _replica_x(rng, r, n, d, cuda_device)
    weight, b = _replica_weights(rng, r, d, cuda_device)
    before = (bsr_spmm.BATCHED_SPMM_LAUNCHES, bsr_spmm.BATCHED_FUSED_LAUNCHES)
    xg = x.clone().requires_grad_()
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, xg)
    (dx,) = torch.autograd.grad((y * g).sum(), xg)
    z = bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, weight.transpose(-1, -2), b)
    torch.cuda.synchronize()
    assert (bsr_spmm.BATCHED_SPMM_LAUNCHES,
            bsr_spmm.BATCHED_FUSED_LAUNCHES) == (before[0] + 2, before[1] + 1)
    for got, mat, v in ((y.detach(), op.fwd, x), (dx, op.bwd, g)):
        assert _max_rel(got, bsr_spmm.bsr_spmm_plain(mat, v)) <= 1e-5
        emu = bsr_spmm.bsr_spmm_split_plain(mat, v)
        assert float((got - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
    emu = bsr_spmm.bsr_fused_rhs_split_plain(op.fwd, x,
                                             weight.transpose(-1, -2), b)
    assert float((z - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
    assert _max_rel(z, bsr_spmm.bsr_fused_rhs_plain(
        op.fwd, x, weight.transpose(-1, -2), b)) <= 1e-5
    for i in range(r):
        assert torch.equal(y[i], bsr_spmm.bsr_spmm(op.fwd, op.bwd, x[i]))
        assert torch.equal(dx[i], bsr_spmm.bsr_spmm(op.bwd, op.fwd,
                                                    g[i].contiguous()))
        assert torch.equal(z[i], bsr_spmm.bsr_fused_rhs(
            op.fwd, op.bwd, x[i], weight[i].t(), b[i]))


@pytest.mark.parametrize("fmt,fused,needed", [
    ("dense", True, "fused_rhs_batched"), ("coo", False, "coo_spmv_batched"),
    ("bsr", False, "bsr_spmm_batched"), ("bsr", True, "bsr_fused_rhs_batched")])
def test_replica_train_step_on_cuda_matches_cpu(cuda_device, fmt, fused,
                                                needed):
    """One replica-sweep train step (R = 3, grid400, hidden 20) on the card
    against the CPU: losses within 1e-4 and the updated parameters within
    1e-3 rel-L1, equal NFE per replica; only the batched forms launch."""
    from ndcn_tpu_torch.parallel.sweep import (make_ndcn_replica_train_step,
                                               replica_generators)
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    vt = np.linspace(0.0, 2.0, 10).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (400, 1)) \
        .astype(np.float32)
    target = np.random.RandomState(1).rand(10, 400, 1).astype(np.float32)

    def step(dev):
        op = as_operator(mat, sparse=fmt != "dense", format=fmt, device=dev)
        init_fn, step_fn = make_ndcn_replica_train_step(
            op, vt, torch.as_tensor(x0, device=dev),
            torch.as_tensor(target, device=dev), fused=fused)
        model, opt = init_fn(replica_generators(3, 3))
        losses = step_fn(model, opt)
        return losses.cpu(), [p.detach().cpu() for p in model.parameters()]

    kernels.reset_launch_counts()
    losses, params = step(cuda_device)
    counts = kernels.launch_counts()
    assert counts[needed] > 0
    assert all(c == 0 for name, c in counts.items()
               if not name.endswith("batched"))
    losses_cpu, params_cpu = step("cpu")
    assert float((losses - losses_cpu).abs().max()) <= 1e-4
    for p, q in zip(params, params_cpu):
        assert _rel_l1(p, q) <= 1e-3


# ------------------------------------------- the mesh path's row blocks
def _hub_state(n, seed, d):
    """A power-law graph with one hub row of 3,000 edges (its chunks
    fall inside one row block), and an (n, d) state."""
    a, x = _power_law_coo(n, 12 * n, seed, d)
    rng = np.random.RandomState(seed + 1)
    hub = sp.coo_matrix((rng.randn(3000).astype(np.float32),
                         (np.full(3000, n // 3),
                          rng.choice(n, 3000, replace=False))), shape=(n, n))
    a = (a + hub).tocsr()
    a.sum_duplicates()
    return a, x


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_row_block_kernels_match_the_whole_launch(cuda_device, p, bf16):
    """K1, K1ᵀ and K1-fm on each of p row blocks against the gathered
    table: concatenated, bit-equal to the whole operator's launch, and
    within K1's 1e-5·max|y| of the plain version (the 3,000-edge hub row
    sums in another order: 1.0e-6·max|y| measured)."""
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    a, x_np = _hub_state(3001, 5, 20)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x_np, device=cuda_device)
    xT = torch.zeros((24, op.n), device=cuda_device)
    xT[:20] = x.t()
    with coo_spmv.gather_precision(bf16):
        blocks = [shard_coo_at(op, p, r, None) for r in range(p)]
        assert sum(b.block.split.long_rows.numel() for b in blocks) > 0
        n_pad = blocks[0].n_pad
        table = torch.cat([x, x.new_zeros((n_pad - op.n, 20))])
        packed = coo_spmv.pack_rows(xT, bf16)
        packed = torch.cat([packed, packed.new_zeros((n_pad - op.n, 24))])
        for whole_op, pick in ((op, lambda b: b.block),
                               (op.transpose(), lambda b: b.block_t)):
            y = torch.cat([coo_spmv._apply(pick(b), table)[:b.stop - b.start]
                           for b in blocks])
            yT = torch.cat([coo_spmv.gather_T(pick(b), packed)
                            [:, :b.stop - b.start] for b in blocks], dim=1)
            torch.cuda.synchronize()
            assert torch.equal(y, coo_spmv._apply(whole_op, x))
            assert torch.equal(yT, coo_spmv._apply_T(whole_op, xT))
            ref = coo_spmv.coo_spmv_plain(whole_op.rows, whole_op.cols,
                                          whole_op.vals, x, op.n, bf16)
            assert float((y - ref).abs().max()) <= \
                1e-5 * float(ref.abs().max())
            assert float((yT[:20] - ref.t()).abs().max()) <= \
                1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("d", [5, 16])
@pytest.mark.parametrize("p", [2, 4])
def test_row_block_k1_at_the_model_axis_paths_widths(cuda_device, p, d):
    """K1 and K1ᵀ on each of p row blocks at the widths the model axis's
    new paths give them (d = 5: the temporal baselines' graph product; d =
    16: the GCN zoo's hidden width): concatenated, bit-equal to the whole
    operator's launch, and within 1e-5·max|y| of the plain version."""
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    a, x_np = _hub_state(3001, 10 + d, d)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x_np, device=cuda_device)
    blocks = [shard_coo_at(op, p, r, None) for r in range(p)]
    table = torch.cat([x, x.new_zeros((blocks[0].n_pad - op.n, d))])
    for whole_op, pick in ((op, lambda b: b.block),
                           (op.transpose(), lambda b: b.block_t)):
        y = torch.cat([coo_spmv._apply(pick(b), table)[:b.stop - b.start]
                       for b in blocks])
        torch.cuda.synchronize()
        assert torch.equal(y, coo_spmv._apply(whole_op, x))
        ref = coo_spmv.coo_spmv_plain(whole_op.rows, whole_op.cols,
                                      whole_op.vals, x, op.n)
        assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_one_rank_nccl_matvec_matches_plain(cuda_device):
    """The row-sharded product on a one-rank NCCL group (the whole
    operator as one row block, no collective): K1 forward and over Aᵀ,
    against the plain version, and K1-fm's sharded form likewise."""
    import torch.distributed as dist

    from ndcn_tpu_torch.graph.sparse import matvec
    from ndcn_tpu_torch.parallel import coo_shard
    from ndcn_tpu_torch.parallel.mesh import make_mesh, process_group

    a, x_np = _hub_state(3001, 6, 20)
    op = from_scipy_coo(a, device=cuda_device)
    with process_group(cuda_device):
        assert dist.get_backend() == "nccl"
        rs = coo_shard.shard_coo_rows(op, make_mesh(cuda_device))
        before = (coo_spmv.ROWBLOCK_LAUNCHES, coo_spmv.T_ROWBLOCK_LAUNCHES,
                  coo_spmv.LAUNCHES, coo_spmv.T_LAUNCHES)
        x = torch.as_tensor(x_np, device=cuda_device).requires_grad_()
        y = matvec(rs, x)
        y.backward(torch.ones_like(y))
        xT = torch.zeros((24, op.n), device=cuda_device)
        xT[:20] = x.detach().t()
        yT = coo_shard.rs_spmv_T(rs, xT)
        torch.cuda.synchronize()
        # the row-block launches count there alone
        assert (coo_spmv.ROWBLOCK_LAUNCHES, coo_spmv.T_ROWBLOCK_LAUNCHES,
                coo_spmv.LAUNCHES, coo_spmv.T_LAUNCHES) == (
            before[0] + 2, before[1] + 1, before[2], before[3])
    assert not dist.is_initialized()
    ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x.detach(),
                                  op.n)
    ref_t = coo_spmv.coo_spmv_plain(op.rows_t, op.cols_t, op.vals_t,
                                    torch.ones_like(ref), op.n)
    scale = float(ref.abs().max())
    assert float((y.detach() - ref).abs().max()) <= 1e-5 * scale
    assert float((yT[:20] - ref.t()).abs().max()) <= 1e-5 * scale
    assert float((x.grad - ref_t).abs().max()) <= \
        1e-5 * float(ref_t.abs().max())


@pytest.mark.parametrize("p", [2, 4])
def test_batched_row_block_k1_matches_solo_launches(cuda_device, p):
    """K1's batched form on each of p row blocks (R = 3 replicas; the
    table's replica stride n_pad rows, the output's the block's): each
    replica bit-equal to its own one-replica launch on the block, the
    blocks concatenated bit-equal to the whole batched launch, and within
    1e-5·max|y| of the plain version."""
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    a, x_np = _hub_state(3001, 7, 20)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(np.stack([x_np, x_np[::-1].copy(), -2 * x_np]),
                        device=cuda_device)
    blocks = [shard_coo_at(op, p, r, None) for r in range(p)]
    table = torch.cat([x, x.new_zeros((3, blocks[0].n_pad - op.n, 20))], 1)
    before = (coo_spmv.ROWBLOCK_LAUNCHES, coo_spmv.BATCHED_LAUNCHES)
    parts = []
    for b in blocks:
        y = coo_spmv._apply(b.block, table)
        for i in range(3):
            assert torch.equal(y[i], coo_spmv._apply(b.block,
                                                     table[i].contiguous()))
        parts.append(y[:, :b.stop - b.start])
    y = torch.cat(parts, 1)
    torch.cuda.synchronize()
    # a launch on a row block counts there alone: p batched and 3 · p
    # one-replica launches
    assert (coo_spmv.ROWBLOCK_LAUNCHES, coo_spmv.BATCHED_LAUNCHES) == (
        before[0] + 4 * p, before[1])
    assert torch.equal(y, coo_spmv._apply(op, x))
    ref = coo_spmv.coo_spmv_plain(op.rows, op.cols, op.vals, x, op.n)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("fmt,fused,kernel", [
    ("dense", "auto", "fused_rhs"), ("coo", False, "coo_spmv"),
    ("bsr", False, "bsr_spmm"), ("bsr", "auto", "bsr_fused_rhs")])
def test_artifact_on_cuda_launches_its_kernel_and_matches_the_server(
        cuda_device, fmt, fused, kernel):
    """The serving artifact exported on the card (``serve.export_ndcn``)
    runs its kernel's CUDA implementation: one launch an RHS evaluation,
    as the in-process server, and the server's answer within 1e-6; an
    eager ``solve_while`` on the card repeats ``solve`` bit for bit."""
    from ndcn_tpu_torch.models.ndcn import ode_func
    from ndcn_tpu_torch.ode import adaptive
    from ndcn_tpu_torch.ode.step_control import Controller
    from ndcn_tpu_torch.serve import export_ndcn, load_ndcn

    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    op = as_operator(mat, sparse=fmt != "dense", format=fmt,
                     device=cuda_device)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                      device=cuda_device)
    vt = np.linspace(0.0, 5.0, 12).astype(np.float32)
    x = np.random.RandomState(1).uniform(0.0, 25.0, (400, 1)).astype(
        np.float32)
    kw = dict(rtol=0.01, atol=0.001, method="dopri5", fused=fused)
    serve = load_ndcn(export_ndcn(model, op, vt, x.shape, **kw))
    server = make_server(model, op, vt, **kw)
    ref, ok = server(x)
    kernels.reset_launch_counts()
    out, success = serve(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert out.device.type == "cuda" and bool(success) and ok
    assert counts[kernel] == server.last_stats.nfe > 0
    assert float((out - ref).abs().max()) <= 1e-6
    h0 = torch.as_tensor(np.random.RandomState(2).uniform(
        -1, 1, (400, 20)).astype(np.float32), device=cuda_device)
    with torch.no_grad():
        def func(t, h):
            return ode_func(model, op, t, h, fused=fused)

        ctrl = Controller(rtol=0.01, atol=0.001)
        a, sa = adaptive.solve(adaptive.DOPRI5_METHOD, func, h0,
                               torch.as_tensor(vt), ctrl, 1 << 16)
        b, sb = adaptive.solve_while(adaptive.DOPRI5_METHOD, func, h0,
                                     torch.as_tensor(vt), ctrl, 1 << 16)
    assert torch.equal(a, b) and sa.nfe == int(sb.nfe)


# ------------------------------- K1-fm and K5 as operators, the new paths
@pytest.mark.parametrize("bf16", [False, True])
def test_k1fm_and_k5_operators_match_plain_and_the_eager_wrapper(
        cuda_device, bf16):
    """``ndcn_tpu_torch::pack_rows``, ``::gather_T`` and
    ``::gather_T_wide`` (what the feature-major artifact holds) on the
    card: each its kernel, counted as the wrapper counts it, within
    1e-5·max|y| of the plain version and bit-equal to the eager
    wrapper."""
    a, x = _hub_state(5000, 3, 20)
    op = from_scipy_coo(a, device=cuda_device)
    xT = torch.as_tensor(np.ascontiguousarray(
        np.pad(x, ((0, 0), (0, 4))).T), device=cuda_device)
    ops = torch.ops.ndcn_tpu_torch
    csr = (op.row_ptr, op.rows, op.cols, op.vals, *op.split[:3],
           op.split.limit)
    kernels.reset_launch_counts()
    table = ops.pack_rows(xT, bf16)
    y = ops.gather_T(*csr, table)
    wide_table = coo_spmv.pack_rows_plain(xT, bf16)
    y_wide = ops.gather_T_wide(*csr, wide_table)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["coo_spmv_T_pack"], counts["coo_spmv_T"],
            counts["coo_spmv_T_wide"]) == (1, 1, 1)
    assert torch.equal(table, coo_spmv.pack_rows_plain(xT, bf16))
    ref = coo_spmv.coo_spmv_T_plain(op.rows, op.cols, op.vals, xT, op.n,
                                    bf16)
    for got in (y, y_wide):
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())
    with coo_spmv.gather_precision(bf16):
        assert torch.equal(y, coo_spmv.spmv_T(op, xT))
        coo_spmv.GATHER_WIDE = True
        try:
            assert torch.equal(y_wide, coo_spmv.spmv_T(op, xT))
        finally:
            coo_spmv.GATHER_WIDE = False


@pytest.mark.parametrize("method", ["dopri5", "adams"])
def test_batched_adjoint_step_on_cuda_matches_cpu(cuda_device, method):
    """One replica-sweep step with the batched continuous adjoint (R = 3,
    grid400 COO, hidden 20) on the card against the CPU: losses within
    1e-4, updated parameters within 1e-3 rel-L1; K1's batched form runs
    forward and over Aᵀ in the VJPs, no one-replica launch."""
    from ndcn_tpu_torch.parallel.sweep import (make_ndcn_replica_train_step,
                                               replica_generators)
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    vt = np.linspace(0.0, 2.0, 6).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (400, 1)) \
        .astype(np.float32)
    target = np.random.RandomState(1).rand(6, 400, 1).astype(np.float32)

    def step(dev):
        op = as_operator(sp.csr_matrix(lap), sparse=True, format="coo",
                         device=dev)
        init_fn, step_fn = make_ndcn_replica_train_step(
            op, vt, torch.as_tensor(x0, device=dev),
            torch.as_tensor(target, device=dev), method=method,
            adjoint=True)
        model, opt = init_fn(replica_generators(3, 3))
        losses = step_fn(model, opt)
        return losses.cpu(), [p.detach().cpu() for p in model.parameters()]

    kernels.reset_launch_counts()
    losses, params = step(cuda_device)
    counts = kernels.launch_counts()
    assert counts["coo_spmv_batched"] > 0 and counts["coo_spmv"] == 0
    losses_cpu, params_cpu = step("cpu")
    assert float((losses - losses_cpu).abs().max()) <= 1e-4
    for p, q in zip(params, params_cpu):
        assert _rel_l1(p, q) <= 1e-3


# the last narrow and the first wide width of each load (fp32: 16-byte
# loads to d = 128, 4-byte ones at 129; bf16: 16-byte loads to 256, 264 the
# first wide one, 2-byte ones at 257), and the citation graphs' raw features
_WIDE_CASES = [(d, False) for d in (128, 129, 132, 1433, 3703)] + [
    (d, True) for d in (256, 257, 264, 1433)]


@pytest.mark.parametrize("limit", [256, 16])
@pytest.mark.parametrize("r", [1, 3])
@pytest.mark.parametrize("d,bf16", _WIDE_CASES)
def test_k1_wide_form_cuda_matches_plain_narrow_and_solo(cuda_device, d,
                                                         bf16, r, limit):
    """K1 at the widths around a warp's 32 loads, on a hub graph whose
    2,000-edge row is past ``SPLIT_EDGES`` (and at a split limit of 16,
    where most rows are): one replica and batched (R = 3), forward and
    through autograd (over the transpose), fp32 and bf16. Within 1e-5 of
    the plain version, two calls bit-equal, each replica bit-equal to its
    own launch, and bit-equal to the narrow form's sums (the launch of
    every width before the wide form); the wide form launched exactly
    where the plan says."""
    n = 3001
    a = _hub_coo(n, 40000, 2000, seed=d)
    op = _resplit(from_scipy_coo(a, device=cuda_device), limit)
    assert op.split.long_rows.numel() > 0
    rng = np.random.RandomState(d + r)
    x = _replica_x(rng, r, n, d, cuda_device)
    g = _replica_x(rng, r, n, d, cuda_device)
    table = x.to(torch.bfloat16) if bf16 else x
    plan = coo_spmv.gather_plan(d, coo_spmv._gather_width(table[0]),
                                table.element_size())
    kernels.reset_launch_counts()
    with coo_spmv.gather_precision(bf16):
        xg = x.clone().requires_grad_()
        y = coo_spmv.coo_spmv(op, xg if r > 1 else xg[0])
        (dx,) = torch.autograd.grad((y * (g if r > 1 else g[0])).sum(), xg)
        torch.cuda.synchronize()
        wide = kernels.launch_counts()["coo_spmv_wide_batched" if r > 1
                                       else "coo_spmv_wide"]
        assert wide == (2 if plan.wide else 0)
        y = y.detach().reshape(r, n, d)
        for got, o, v in ((y, op, x), (dx, op.transpose(), g)):
            ref = coo_spmv.coo_spmv_plain(o.rows, o.cols, o.vals, v, n, bf16)
            assert _max_rel(got, ref) <= 1e-5
            assert torch.equal(got, coo_spmv.coo_spmv(o, v if r > 1
                                                      else v[0]).reshape(
                                                          r, n, d))
            for i in range(r):
                one = coo_spmv.coo_spmv(o, v[i].contiguous())
                assert torch.equal(got[i], one)
                assert torch.equal(one, coo_spmv.coo_spmv_narrow(
                    o, v[i].contiguous(), bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_row_block_k1_wide_form_matches_the_whole_launch(cuda_device, p,
                                                         bf16):
    """K1's wide form on each of p row blocks (d = 1433, the table of every
    node's rows), one replica and R = 3: the blocks concatenated bit-equal
    to the whole operator's launch, each replica bit-equal to its own
    launch on the block, within 1e-5·max|y| of the plain version."""
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    d = 1433
    a, _ = _hub_state(3001, 9, 1)
    op = from_scipy_coo(a, device=cuda_device)
    rng = np.random.RandomState(p)
    x = _replica_x(rng, 3, op.n, d, cuda_device)
    with coo_spmv.gather_precision(bf16):
        blocks = [shard_coo_at(op, p, r, None) for r in range(p)]
        pad = blocks[0].n_pad - op.n
        table = torch.cat([x, x.new_zeros((3, pad, d))], 1)
        for whole_op, pick in ((op, lambda b: b.block),
                               (op.transpose(), lambda b: b.block_t)):
            parts = []
            for b in blocks:
                yb = coo_spmv._apply(pick(b), table)
                for i in range(3):
                    assert torch.equal(yb[i], coo_spmv._apply(
                        pick(b), table[i].contiguous()))
                parts.append(yb[:, :b.stop - b.start])
            y = torch.cat(parts, 1)
            torch.cuda.synchronize()
            assert torch.equal(y, coo_spmv._apply(whole_op, x))
            ref = coo_spmv.coo_spmv_plain(whole_op.rows, whole_op.cols,
                                          whole_op.vals, x, op.n, bf16)
            assert _max_rel(y, ref) <= 1e-5


def _bsr_cases():
    """A 2,708-node random matrix that stores ~97 % of its 128 x 128
    blocks (cora's operator stores 468 of 484), and the grid400 Laplacian
    (10 of 16)."""
    rng = np.random.RandomState(16)
    return {"dense_blocks": sp.random(2708, 2708, density=2.4e-4,
                                      random_state=rng, format="csr",
                                      dtype=np.float32)
            + sp.eye(2708, dtype=np.float32, format="csr"),
            "grid400": sp.csr_matrix(operators.normalized_laplacian(
                generators.build_network("grid", 400)).astype(np.float32))}


@pytest.fixture(scope="module")
def bsr_cases():
    return _bsr_cases()


@pytest.mark.parametrize("r", [1, 3, 25])
@pytest.mark.parametrize("d", [5, 16, 20, 256])
@pytest.mark.parametrize("case", ["dense_blocks", "grid400"])
def test_k3_replica_groups_cuda_match_plain_and_solo_launches(
        cuda_device, bsr_cases, case, d, r):
    """K3's batched form (replica groups where the plan takes them, the
    replica grid where not), forward and over Aᵀ through autograd: within
    1e-5 of the plain version and 2e-6 of the split emulation, two calls
    bit-equal, each replica bit-equal to its own one-replica launch, and
    the grouped entry launched exactly where the plan has groups."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
    mat = bsr_cases[case]
    op = from_scipy_bsr_graph(mat, device=cuda_device)
    if case == "dense_blocks":
        assert op.fwd.blocks.shape[0] >= 0.95 * op.fwd.n_row_blocks ** 2
    rng = np.random.RandomState(d + r)
    n = op.n
    x = torch.as_tensor(rng.rand(r, n, d).astype(np.float32),
                        device=cuda_device)
    g = _replica_x(rng, r, n, d, cuda_device)
    plan = bsr_spmm.bsr_batched_plan(op.fwd.n_row_blocks, op.fwd.block, d, r)
    kernels.reset_launch_counts()
    xg = x.clone().requires_grad_()
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, xg)
    (dx,) = torch.autograd.grad((y * g).sum(), xg)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["bsr_spmm_batched"] == 2
    assert counts["bsr_spmm_grouped_batched"] == (2 if plan.group > 1 else 0)
    for got, mat_, v in ((y.detach(), op.fwd, x), (dx, op.bwd, g)):
        assert _max_rel(got, bsr_spmm.bsr_spmm_plain(mat_, v)) <= 1e-5
        emu = bsr_spmm.bsr_spmm_split_plain(mat_, v)
        assert float((got - emu).abs().max()) <= 2e-6 * float(emu.abs().max())
        other = op.bwd if mat_ is op.fwd else op.fwd
        assert torch.equal(got, bsr_spmm.bsr_spmm(mat_, other, v))
        for i in range(r):
            assert torch.equal(got[i], bsr_spmm.bsr_spmm(mat_, other,
                                                         v[i].contiguous()))


# ------------------------------------------------------------ the scan path

MAX_STEPS = 24   # the bounded solve's attempts in ``_heat_step``


def _heat_step(device, fmt, fused, dropout=0.0, rng=None, n=100,
               method="dopri5", adjoint=False, shard=None, record=None):
    """A model, its CapturableAdam and the bounded train step (the solve's
    ``scan`` option) on an n-node grid's heat problem; ``shard`` maps the
    operator to its row block (the gradients are then summed over its
    group); ``record``, a list, gets each call's solve stats."""
    from ndcn_tpu_torch.experiments.dynamics import nan_unless_ok
    from ndcn_tpu_torch.parallel.coo_shard import node_group
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    lap = operators.normalized_laplacian(generators.build_network("grid", n))
    op = as_operator(lap if fmt == "dense" else sp.csr_matrix(lap),
                     sparse=fmt != "dense", format=fmt, device=device)
    if shard is not None:
        op = shard(op)
    rs = np.random.RandomState(0)
    x0 = torch.as_tensor(rs.rand(n, 1).astype(np.float32), device=device)
    vt = torch.linspace(0.0, 2.0, 9, device=device)
    target = torch.as_tensor(rs.rand(n, 9).astype(np.float32), device=device)
    model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                      device=device)
    opt = torch_adam(model.parameters(), 0.01, 1e-3, capturable=True)

    group = node_group(op)

    def loss_fn():
        out, stats = ndcn_forward(model, op, vt, x0, fused=fused,
                                  max_steps=MAX_STEPS, scan=True,
                                  dropout=dropout, rng=rng, rtol=0.01,
                                  atol=0.001, method=method, adjoint=adjoint)
        if record is not None:
            record.append(stats)
        loss = nan_unless_ok(stats.success, l1_loss(out[..., 0].T, target,
                                                     group))
        return loss, loss / target.mean()

    return model, opt, make_sgd_step(opt, loss_fn, group)


@pytest.mark.parametrize("fmt,fused,dropout", [
    ("dense", "auto", 0.0), ("bsr", "auto", 0.0), ("coo", False, 0.0),
    ("coo", False, 0.2)])
def test_graphed_step_is_bit_equal_to_the_eager_bounded_step(
        cuda_device, fmt, fused, dropout):
    """Three train steps as CUDA graph replays (``train.chunk``) against
    the same steps run eagerly: losses and parameters bit-equal, one host
    read; with dropout the masks come from a card generator the graph
    registers. Every attempt of the solve sits behind a conditional node,
    in the forward and in the backward."""
    from ndcn_tpu_torch.train.chunk import TrainChunk

    def gen():
        return (torch.Generator(cuda_device).manual_seed(5) if dropout
                else None)

    g_e, g_g = gen(), gen()
    m_e, _, eager = _heat_step(cuda_device, fmt, fused, dropout, g_e)
    m_g, o_g, graphed = _heat_step(cuda_device, fmt, fused, dropout, g_g)
    losses = [float(eager()[0]) for _ in range(3)]
    chunk = TrainChunk(graphed, m_g.parameters(), o_g, g_g)
    loss, _ = chunk(3)
    assert chunk.host_reads == 1 and chunk.replays == 3
    assert chunk.gated_attempts == 2 * MAX_STEPS
    assert np.isfinite(loss) and loss == losses[-1]
    assert all(torch.equal(a, b) for a, b in zip(m_e.parameters(),
                                                 m_g.parameters()))
    chunk.release()


@pytest.mark.parametrize("method,adjoint,fmt,fused", [
    ("adams", False, "dense", "auto"), ("explicit_adams", False, "dense",
                                        "auto"),
    ("fixed_adams", False, "coo", False), ("dopri5", True, "dense", "auto"),
    ("dopri5", True, "coo", False), ("dopri5", True, "bsr", "auto"),
    ("adams", True, "dense", "auto")])
def test_graphed_adams_and_adjoint_steps_are_bit_equal_to_eager(
        cuda_device, method, adjoint, fmt, fused):
    """The Adams family and the continuous adjoint under ``scan``: three
    train steps as CUDA graph replays against the same steps run eagerly,
    losses and parameters bit-equal, one host read. dopri5's adjoint gates
    every attempt of its inference solves (the forward and one an interval
    of the backward: 9 grid points); the Adams family's attempts stay
    masked."""
    from ndcn_tpu_torch.train.chunk import TrainChunk

    m_e, _, eager = _heat_step(cuda_device, fmt, fused, method=method,
                               adjoint=adjoint)
    m_g, o_g, graphed = _heat_step(cuda_device, fmt, fused, method=method,
                                   adjoint=adjoint)
    losses = [float(eager()[0]) for _ in range(3)]
    chunk = TrainChunk(graphed, m_g.parameters(), o_g)
    loss, _ = chunk(3)
    assert chunk.host_reads == 1 and chunk.replays == 3
    assert chunk.gated_attempts == (9 * MAX_STEPS if method == "dopri5"
                                    else 0)
    assert np.isfinite(loss) and loss == losses[-1]
    assert all(torch.equal(a, b) for a, b in zip(m_e.parameters(),
                                                 m_g.parameters()))
    chunk.release()


def test_graphed_step_on_a_one_rank_nccl_row_block(cuda_device):
    """``--mesh --scan_chunk`` on a one-rank NCCL group: the step on the
    operator's row block over the world group (every collective of the
    solve's norms and the gradients' sum runs, and the graph records them)
    as three graph replays against the same steps eager, bit-equal, one
    host read, and against the unsharded eager steps (1e-5)."""
    import torch.distributed as dist

    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at
    from ndcn_tpu_torch.parallel.mesh import process_group
    from ndcn_tpu_torch.train.chunk import TrainChunk

    def shard(op):
        return shard_coo_at(op, 1, 0, None)._replace(group=dist.group.WORLD)

    with process_group(cuda_device):
        assert dist.get_backend() == "nccl"
        kw = dict(dropout=0.2, shard=shard)
        g_e, g_g = (torch.Generator(cuda_device).manual_seed(5)
                    for _ in range(2))
        m_e, _, eager = _heat_step(cuda_device, "coo", False, rng=g_e, **kw)
        m_g, o_g, graphed = _heat_step(cuda_device, "coo", False, rng=g_g,
                                       **kw)
        _, _, whole = _heat_step(cuda_device, "coo", False, dropout=0.2,
                                 rng=torch.Generator(cuda_device).manual_seed(
                                     5))
        losses = [float(eager()[0]) for _ in range(3)]
        ref = [float(whole()[0]) for _ in range(3)]
        before = coo_spmv.ROWBLOCK_LAUNCHES
        chunk = TrainChunk(graphed, m_g.parameters(), o_g, g_g)
        loss, _ = chunk(3)
        torch.cuda.synchronize()
        assert coo_spmv.ROWBLOCK_LAUNCHES > before
        assert chunk.host_reads == 1 and chunk.replays == 3
        assert chunk.gated_attempts == 0    # collectives: masked attempts
        assert loss == losses[-1]
        assert all(torch.equal(a, b) for a, b in zip(m_e.parameters(),
                                                     m_g.parameters()))
        assert np.allclose(losses, ref, rtol=1e-5, atol=0)
        chunk.release()
    assert not dist.is_initialized()


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_graphed_grid400_step_skips_the_frozen_attempts(cuda_device, method):
    """One replay of the grid400 step (dense, K2) under the profiler: K2
    runs twice for the initial step and 6 + 6 times a live attempt (its
    forward and its recomputation), none for a frozen one, and the replay
    runs fewer kernels than the eager step, which runs every attempt."""
    from torch.profiler import ProfilerActivity, profile

    from ndcn_tpu_torch.train.chunk import TrainChunk

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        k2 = sum(1 for name in names if "fused_rhs_kernel" in name)
        return len(names), k2

    stats = []
    _, _, eager = _heat_step(cuda_device, "dense", True, n=400,
                             method=method)
    eager()
    n_eager, k2_eager = kernels(eager)
    model, opt, graphed = _heat_step(cuda_device, "dense", True, n=400,
                                     method=method, record=stats)
    chunk = TrainChunk(graphed, model.parameters(), opt)
    chunk.capture()
    n_replay, k2_replay = kernels(chunk.graph.replay)
    st = stats[-1]          # the captured step's stats: this replay's
    live = int(st.n_accepted) + int(st.n_rejected)
    assert 0 < live < MAX_STEPS and chunk.gated_attempts == 2 * MAX_STEPS
    assert k2_eager == 2 + 12 * MAX_STEPS
    assert k2_replay == 2 + 12 * live
    assert n_replay < n_eager
    chunk.release()


def test_chunk_captures_again_after_a_rollback(cuda_device):
    """An optimizer state loaded with ``load_state_dict`` (the elastic
    rollback) needs a new chunk, which captures again and replays the
    steps the first one took from that state, bit for bit."""
    import copy

    from ndcn_tpu_torch.train.chunk import TrainChunk

    model, opt, step = _heat_step(cuda_device, "dense", "auto")
    first = TrainChunk(step, model.parameters(), opt)
    first(2)
    snap = copy.deepcopy((model.state_dict(), opt.state_dict()))
    after = [first(1)[0], first(1)[0]]
    params = [p.detach().clone() for p in model.parameters()]
    first.release()
    model.load_state_dict(snap[0])
    opt.load_state_dict(snap[1])
    again = TrainChunk(step, model.parameters(), opt)
    assert [again(1)[0], again(1)[0]] == after
    assert again.graph is not None
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), params))


def test_precision_high_leaves_k2_and_k4_bit_equal(cuda_device):
    """``--precision high`` (TF32 for PyTorch's float32 products) does not
    reach the split-TF32 kernels: K2 and K4 give the same bits."""
    from ndcn_tpu_torch.kernels.platform import matmul_precision

    a, h, w, b = _fused_inputs(400, 20, 3, cuda_device)
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    op = as_operator(sp.csr_matrix(lap), sparse=True, format="bsr",
                     device=cuda_device)

    def both():
        out = (fused_rhs.fused_rhs(a, h, w, b),
               bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, h, w, b))
        torch.cuda.synchronize()
        return out

    ref = both()
    with matmul_precision("high"):
        assert torch.get_float32_matmul_precision() == "high"
        got = both()
    assert torch.get_float32_matmul_precision() == "highest"
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
