"""The port's CUDA kernels on the GPU, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no jax, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Bounds: max|Δ| <= 1e-5·max|y| for K1 and rtol 1e-5 / atol 1e-5·max|y| for K2
(fp32 sums in another order), 1e-4 rel-L1 for a served trajectory on the GPU
against the same server on the CPU.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu_torch import kernels
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_scipy_coo
from ndcn_tpu_torch.kernels import coo_spmv, fused_rhs
from ndcn_tpu_torch.models import init_ndcn
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


def test_cuda_kernels_refuse_inputs_that_need_a_backward(cuda_device):
    a, x = _power_law_coo(100, 500, seed=3, d=4)
    op = from_scipy_coo(a, device=cuda_device)
    x = torch.as_tensor(x, device=cuda_device).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
        coo_spmv.coo_spmv(op, x)
    a, h, w, b = _fused_inputs(20, 4, seed=0, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP item 2"):
        fused_rhs.fused_rhs(a, h, w.requires_grad_(), b)
    with torch.no_grad():
        fused_rhs.fused_rhs(a, h, w, b)


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
