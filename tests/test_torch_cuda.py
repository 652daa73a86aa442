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
Backward checks use non-symmetric matrices.
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
