"""The port's CUDA kernels on the GPU, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no jax, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Bounds: max|Δ| <= 1e-5·max|y| for K1 (fp32 and bf16), K1ᵀ, K1-fm, K5, K3,
K4, the sliced-tile reduce and the row gather (exact), and rtol 1e-5 /
atol 1e-5·max|y| for K2 and its backward (fp32 sums in another order); 1e-4
rel-L1 for a served trajectory on the GPU against the same server on the CPU,
and 1e-3 rel-L1 for a train step's gradients on the GPU against the CPU.
Backward checks use non-symmetric matrices.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu_torch import kernels
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_scipy_coo
from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs, sparse_bench
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


@pytest.mark.parametrize("n,k", [(400, 20), (275, 13), (70, 33), (64, 300)])
def test_k2_cuda_matches_plain(cuda_device, n, k):
    a, h, w, b = _fused_inputs(n, k, seed=k, device=cuda_device)
    before = fused_rhs.LAUNCHES
    y = fused_rhs.fused_rhs(a, h, w.t().contiguous().t(), b)
    ref = fused_rhs.fused_rhs_plain(a, h, w, b)
    torch.cuda.synchronize()
    assert fused_rhs.LAUNCHES == before + 1
    scale = float(ref.abs().max())
    assert torch.allclose(y, ref, rtol=1e-5, atol=1e-5 * scale)


def _max_rel(y, ref):
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


@pytest.mark.parametrize("n,d,R,E", [(20000, 20, 128, 2048), (3000, 7, 64, 512),
                                     (1000, 40, 256, 300)])
def test_sliced_tile_reduce_cuda_matches_plain_and_oracle(cuda_device, n, d,
                                                          R, E):
    rng = np.random.RandomState(n)
    nnz = n * 11
    rows = np.sort(rng.randint(0, n, nnz))
    rows[:3000] = 5                                   # a hub row: many slices
    rows = np.sort(rows)
    cols = rng.randint(0, n, nnz)
    vals = rng.rand(nnz).astype(np.float32)
    x = rng.rand(n, d).astype(np.float32)
    tiles = sparse_bench.pack_sliced_tiles(rows, cols, vals, n, R, E,
                                           device=cuda_device)
    xT = torch.as_tensor(x.T.copy(), device=cuda_device)
    contrib = xT[:, tiles.cols.long()].contiguous()
    before = sparse_bench.SLICED_LAUNCHES
    out = sparse_bench.sliced_tile_reduce(tiles, contrib)
    ref = sparse_bench.sliced_tile_reduce_plain(tiles, contrib)
    torch.cuda.synchronize()
    assert sparse_bench.SLICED_LAUNCHES == before + 1
    assert _max_rel(out, ref) <= 1e-5
    oracle = np.zeros((n, d), np.float64)
    np.add.at(oracle, rows, vals[:, None].astype(np.float64) * x[cols])
    assert _max_rel(out[:, :n].T.cpu(), torch.as_tensor(oracle)) <= 1e-5
    assert not out[:, n:].any()


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


@pytest.mark.parametrize("n,d,block", [(400, 20, 128), (2000, 256, 128),
                                       (257, 5, 128), (300, 33, 48)])
def test_k3_cuda_matches_plain_forward_and_backward(cuda_device, n, d, block):
    rng = np.random.RandomState(n + d)
    a = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    op = as_operator(a, sparse=True, format="bsr", device=cuda_device)
    if block != 128:
        from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
        op = from_scipy_bsr_graph(a, block=block, device=cuda_device)
    x = torch.as_tensor(rng.randn(n, d).astype(np.float32),
                        device=cuda_device).requires_grad_()
    g = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=cuda_device)
    before = bsr_spmm.SPMM_LAUNCHES
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, x)
    (dx,) = torch.autograd.grad((y * g).sum(), x)
    torch.cuda.synchronize()
    assert bsr_spmm.SPMM_LAUNCHES == before + 2
    assert _max_rel(y, bsr_spmm.bsr_spmm_plain(op.fwd, x)) <= 1e-5
    assert _max_rel(dx, bsr_spmm.bsr_spmm_plain(op.bwd, g)) <= 1e-5
    assert torch.equal(y, bsr_spmm.bsr_spmm(op.fwd, op.bwd, x))  # repeatable


@pytest.mark.parametrize("n,d", [(400, 20), (2000, 256), (300, 513)])
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


@pytest.mark.parametrize("fmt,fused", [("dense", "auto"), ("coo", False),
                                       ("bsr", False), ("bsr", True)])
def test_train_step_gradients_on_cuda_match_cpu(cuda_device, fmt, fused):
    lap = operators.normalized_laplacian(generators.build_network("grid", 400))
    mat = lap if fmt == "dense" else sp.csr_matrix(lap)
    vt = np.linspace(0.0, 2.0, 10).astype(np.float32)
    x0 = np.random.RandomState(0).uniform(0.0, 25.0, (400, 1)) \
        .astype(np.float32)
    target = torch.as_tensor(np.random.RandomState(1).rand(10, 400, 1)
                             .astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda_device):
        model = init_ndcn(torch.Generator().manual_seed(0), 1, 20, 1,
                          device=dev)
        op = as_operator(mat, sparse=fmt != "dense", format=fmt, device=dev)
        out, stats = ndcn_forward(model, op, vt, torch.as_tensor(x0,
                                                                 device=dev),
                                  rtol=0.01, atol=0.001, method="dopri5",
                                  fused=fused)
        (out - target.to(dev)).abs().mean().backward()
        assert stats.success
        grads[str(dev)] = torch.cat([p.grad.flatten().cpu()
                                     for p in model.parameters()])
    cpu, gpu = grads["cpu"], grads[str(cuda_device)]
    assert float((gpu - cpu).abs().sum() / cpu.abs().sum()) <= 1e-3


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
