"""K3 (BSR SpMM) and K4 (the fused BSR RHS): the port's packing and plain
versions against the JAX package.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX package's
own kernel tests run them. Bars: 1e-4·max|y| against the interpret-mode
kernels (their tolerance in ``tests/test_kernels.py``: the same f32 sums in
another order), exact equality for the packing round trip. Backward checks
use non-symmetric matrices: a transpose bug is invisible on a symmetric one.
The CUDA kernels themselves are tested in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.graph.sparse import to_dense_matrix as j_to_dense_matrix
from ndcn_tpu.kernels.bsr_spmm import bsr_fused_rhs as j_bsr_fused_rhs
from ndcn_tpu.kernels.bsr_spmm import bsr_fused_rhs_raw, bsr_spmm_raw
from ndcn_tpu.kernels.bsr_spmm import bsr_spmm as j_bsr_spmm
from ndcn_tpu.kernels.bsr_spmm import from_scipy_bsr as j_from_scipy_bsr
from ndcn_tpu_torch.graph import sparse
from ndcn_tpu_torch.kernels import bsr_spmm


def _rand_sparse(n, density=0.02, seed=0):
    """A non-symmetric random sparse matrix, as the JAX kernel tests build it."""
    rng = np.random.RandomState(seed)
    return sp.random(n, n, density=density, random_state=rng, format="csr"), rng


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def test_bsr_packing_round_trip_matches_jax():
    a, _ = _rand_sparse(200, density=0.05, seed=2)
    op = sparse.as_operator(a, sparse=True, format="bsr")
    assert isinstance(op, sparse.BsrGraph) and op.n == 200
    dense = sparse.to_dense_matrix(op)
    assert np.array_equal(dense, np.asarray(a.todense(), np.float32))
    assert np.array_equal(dense, np.asarray(j_to_dense_matrix(
        j_as_operator(a, sparse=True, format="bsr"))))
    # the transpose packing holds Aᵀ
    assert np.array_equal(sparse.to_dense_matrix(op.transpose()), dense.T)
    assert op.fwd.block == bsr_spmm.BLOCK == 128


@pytest.mark.parametrize("n,block", [(257, 128), (100, 32), (70, 9)])
def test_bsr_rectangular_tail(n, block):
    """Node counts that are not a multiple of the block round-trip exactly,
    at the default block size and at others (the format's parameter)."""
    a, rng = _rand_sparse(n, density=0.05, seed=3)
    x = rng.rand(n, 5).astype(np.float32)
    m = bsr_spmm.from_scipy_bsr(a, block=block)
    assert m.n_row_blocks == -(-n // block) and m.block == block
    y = bsr_spmm.bsr_spmm_plain(m, torch.as_tensor(x)).numpy()
    _close(y, a @ x, 1e-5)
    if block == 128:
        _close(y, bsr_spmm_raw(j_from_scipy_bsr(a), jnp.asarray(x)))


def test_bsr_rejects_other_dtypes_and_formats():
    m = sp.random(64, 64, density=0.05, format="csr", random_state=0)
    with pytest.raises(ValueError, match="float32 only"):
        sparse.as_operator(m, sparse=True, format="bsr", dtype=torch.float64)
    op = sparse.as_operator(m, sparse=True, format="bsr")
    x = torch.ones(64, 3)
    with pytest.raises(TypeError, match="float32"):
        bsr_spmm.bsr_spmm(op.fwd, op.bwd, x.double())
    with pytest.raises(ValueError, match="shape"):
        bsr_spmm.bsr_spmm(op.fwd, op.bwd, x[:10])
    with pytest.raises(ValueError, match="contiguous"):
        bsr_spmm.bsr_spmm(op.fwd, op.bwd, torch.ones(3, 64).t())
    with pytest.raises(ValueError, match="int32"):
        bsr_spmm.bsr_spmm(op.fwd._replace(
            block_cols=op.fwd.block_cols.long()), op.bwd, x)
    with pytest.raises(ValueError, match="w \\(d, d\\)"):
        bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, torch.ones(3, 4),
                               torch.ones(3))


@pytest.mark.parametrize("d", [1, 20, 70])
def test_k3_plain_and_vjp_match_jax_interpret(d):
    a, rng = _rand_sparse(300, density=0.05, seed=1)
    x = rng.rand(300, d).astype(np.float32)
    ja, jat = j_from_scipy_bsr(a), j_from_scipy_bsr(a.T.tocsr())
    op = sparse.as_operator(a, sparse=True, format="bsr")
    xt = torch.as_tensor(x).requires_grad_()
    before = bsr_spmm.SPMM_LAUNCHES
    y = sparse.matvec(op, xt)
    _close(y.detach().numpy(), bsr_spmm_raw(ja, jnp.asarray(x)))
    # d sum(y²)/dx = 2 Aᵀ (A x): the backward runs over the Aᵀ packing
    (gx,) = torch.autograd.grad((y ** 2).sum(), xt)
    g_ref = jax.grad(lambda xx: jnp.sum(j_bsr_spmm(ja, jat, xx) ** 2))(
        jnp.asarray(x))
    _close(gx.numpy(), g_ref)
    _close(gx.numpy(), 2 * (a.T @ (a @ x)))
    assert bsr_spmm.SPMM_LAUNCHES == before  # CPU tensors never launch


@pytest.mark.parametrize("d", [20, 40])
def test_k4_plain_and_vjp_match_jax_interpret(d):
    a, rng = _rand_sparse(260, density=0.05, seed=4)
    x = rng.rand(260, d).astype(np.float32)
    w = (rng.randn(d, d) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    g = rng.randn(260, d).astype(np.float32)
    ja, jat = j_from_scipy_bsr(a), j_from_scipy_bsr(a.T.tocsr())
    op = sparse.as_operator(a, sparse=True, format="bsr")
    xt, bt = torch.as_tensor(x).requires_grad_(), torch.as_tensor(b)
    # w as the strided view nn.Linear hands over (weight.t())
    weight = torch.as_tensor(w.T.copy()).requires_grad_()
    bt.requires_grad_()
    out = bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, xt, weight.t(), bt)
    ref = bsr_fused_rhs_raw(ja, jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(b))
    _close(out.detach().numpy(), ref)
    (out * torch.as_tensor(g)).sum().backward()
    j_grads = jax.grad(lambda xx, ww, bb: jnp.sum(
        j_bsr_fused_rhs(ja, jat, xx, ww, bb) * g), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(xt.grad.numpy(), j_grads[0])
    _close(weight.grad.numpy().T, j_grads[1])   # reached through the view
    _close(bt.grad.numpy(), j_grads[2])


@pytest.mark.parametrize("n,m,d,block,empty", [
    (300, 500, 20, 128, False), (500, 300, 20, 128, False),
    (200, 200, 20, 9, False), (400, 400, 5, 128, True),
    (300, 300, 1100, 128, False)])
def test_k3_plain_and_split_emulation_on_the_cuda_tests_shapes(n, m, d, block,
                                                               empty):
    """The references K3 is held against on the card, at the shapes that
    test adds: a rectangular A and its transpose, block 9, a row block with
    no stored block, d beyond K_MAX; within 1e-5 of float64 forward and over
    the Aᵀ packing, through autograd on the CPU."""
    rng = np.random.RandomState(n + m + d)
    a = sp.random(n, m, density=0.05, random_state=rng, format="lil")
    if empty:
        a[block:2 * block] = 0
    a = a.tocsr()
    op = sparse.from_scipy_bsr_graph(a, block=block)
    assert op.fwd.n_rows == n and op.fwd.n_cols == m
    if empty:
        assert int(op.fwd.row_ptr[2] - op.fwd.row_ptr[1]) == 0
    x = rng.randn(m, d).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    y = bsr_spmm.bsr_spmm(op.fwd, op.bwd, xt)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(g)).sum(), xt)
    a64 = a.astype(np.float64)
    _close(y.detach().numpy(), a64 @ x.astype(np.float64), 1e-5)
    _close(dx.numpy(), a64.T @ g.astype(np.float64), 1e-5)
    _close(bsr_spmm.bsr_spmm_split_plain(op.fwd, torch.as_tensor(x)).numpy(),
           a64 @ x.astype(np.float64), 1e-5)
    _close(bsr_spmm.bsr_spmm_split_plain(op.bwd, torch.as_tensor(g)).numpy(),
           a64.T @ g.astype(np.float64), 1e-5)


def test_bsr_operator_cotangent_is_zero():
    """JAX's BSR policy: the constant operator's cotangent is zero (COO's is
    NaN, ``test_torch_train.py``)."""
    a, rng = _rand_sparse(150, density=0.05, seed=5)
    op = sparse.as_operator(a, sparse=True, format="bsr")
    blocks = op.fwd.blocks.clone().requires_grad_()
    fwd = op.fwd._replace(blocks=blocks)
    x = torch.as_tensor(rng.rand(150, 4).astype(np.float32))
    (gb,) = torch.autograd.grad(bsr_spmm.bsr_spmm(fwd, op.bwd, x).sum(),
                                blocks)
    assert torch.equal(gb, torch.zeros_like(gb))
    w, b = torch.eye(4), torch.zeros(4)
    (gb,) = torch.autograd.grad(
        bsr_spmm.bsr_fused_rhs(fwd, op.bwd, x, w, b).sum(), blocks)
    assert torch.equal(gb, torch.zeros_like(gb))
