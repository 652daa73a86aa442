"""The batched forms of K1, K2, K3 and K4 (R replicas against one shared
operator, the replica sweeps' products) on the CPU, where the wrappers run
their plain versions: against ``jax.vmap`` of the JAX package's Pallas
kernels in interpret mode (the batching rule puts a replica axis in their
grid), and against the port's own one-replica calls, replica by replica.

Bars: 1e-4·max|y| against the interpret-mode kernels (K1's sliced-tile
kernel sums bf16 splits; ``tests/test_torch_kernels.py``'s bar), gradients
too; bit-equal to the one-replica plain versions for K1 and K2 (the same
products, one replica at a time), 1e-6·max|y| for K3 and K4, whose plain
versions take the replicas as the columns of one product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu.kernels.bsr_spmm import bsr_fused_rhs as j_bsr_fused_rhs
from ndcn_tpu.kernels.bsr_spmm import bsr_spmm as j_bsr_spmm
from ndcn_tpu.kernels.bsr_spmm import from_scipy_bsr as j_from_scipy_bsr
from ndcn_tpu.kernels.coo_spmv import tiled_spmv
from ndcn_tpu.kernels.fused_rhs import fused_graph_rhs
from ndcn_tpu_torch.graph import sparse
from ndcn_tpu_torch.graph.sparse import from_scipy_coo
from ndcn_tpu_torch.kernels import bsr_spmm, coo_spmv, fused_rhs

R = 3


def _close(got, ref, tol=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1e-30)


def _matrix(n, seed, density=0.05):
    rng = np.random.RandomState(seed)
    return sp.random(n, n, density=density, random_state=rng,
                     format="csr").astype(np.float32), rng


@pytest.mark.parametrize("d", [1, 16])
def test_batched_k1_plain_matches_vmapped_jax_kernel(d):
    """K1 batched (forward, and the backward over the transpose CSR)
    against ``jax.vmap`` of the sliced-tile kernel in interpret mode."""
    a, rng = _matrix(300, d)
    x = rng.randn(R, 300, d).astype(np.float32)
    g = rng.randn(R, 300, d).astype(np.float32)
    j_op = j_from_scipy_coo(a, tiled=True)

    def j_loss(xx):
        y = jax.vmap(lambda v: tiled_spmv(j_op.tiles, j_op.tiles_t, v))(xx)
        return jnp.sum(y * g), y

    (_, ref), j_dx = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x))
    op = from_scipy_coo(a)
    xt = torch.as_tensor(x).requires_grad_()
    y = coo_spmv.coo_spmv(op, xt)
    (y * torch.as_tensor(g)).sum().backward()
    _close(y.detach(), ref)
    _close(xt.grad, j_dx)
    for i in range(R):
        assert torch.equal(y[i], coo_spmv.coo_spmv(op, xt[i].detach()))


@pytest.mark.parametrize("n,k", [(64, 20), (37, 13)])
def test_batched_k2_plain_matches_vmapped_jax_kernel(n, k):
    """K2 batched, R own (W, b) against one A, and its backward, against
    ``jax.vmap`` of the Pallas fused RHS in interpret mode."""
    rng = np.random.RandomState(n + k)
    a = rng.rand(n, n).astype(np.float32)
    h = rng.rand(R, n, k).astype(np.float32)
    w = (rng.randn(R, k, k) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.randn(R, k)).astype(np.float32)
    ref = jax.vmap(lambda hh, ww, bb: fused_graph_rhs(
        jnp.asarray(a), hh, ww, bb))(h, w, b)
    weight = torch.as_tensor(np.ascontiguousarray(w.transpose(0, 2, 1)))
    ins = [torch.as_tensor(h).requires_grad_(), weight.requires_grad_(),
           torch.as_tensor(b).requires_grad_()]
    at = torch.as_tensor(a)
    out = fused_rhs.fused_rhs(at, ins[0], ins[1].transpose(-1, -2), ins[2])
    _close(out.detach(), ref)
    g = torch.as_tensor(rng.randn(R, n, k).astype(np.float32))
    got = torch.autograd.grad((out * g).sum(), ins)
    want = jax.grad(lambda hh, ww, bb: jnp.sum(jnp.maximum(
        jnp.einsum("nm,rmk->rnk", a, hh) @ ww + bb[:, None], 0) * g.numpy()),
        argnums=(0, 1, 2))(h, w, b)
    _close(got[0], want[0])
    _close(got[1].transpose(-1, -2), want[1])   # through nn.Linear's view
    _close(got[2], want[2])
    for i in range(R):
        assert torch.equal(out[i], fused_rhs.fused_rhs(
            at, ins[0][i].detach(), ins[1][i].detach().t(),
            ins[2][i].detach()))


@pytest.mark.parametrize("d", [1, 20])
def test_batched_k3_k4_plain_match_vmapped_jax_kernels(d):
    """K3 and K4 batched, forward and backward, against ``jax.vmap`` of the
    Pallas BSR kernels in interpret mode."""
    a, rng = _matrix(260, 7 + d)
    x = rng.rand(R, 260, d).astype(np.float32)
    w = (rng.randn(R, d, d) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.randn(R, d)).astype(np.float32)
    g = rng.randn(R, 260, d).astype(np.float32)
    ja, jat = j_from_scipy_bsr(a), j_from_scipy_bsr(a.T.tocsr())
    op = sparse.as_operator(a, sparse=True, format="bsr")

    def j_k3(xx):
        return jnp.sum(jax.vmap(lambda v: j_bsr_spmm(ja, jat, v))(xx) * g)

    def j_k4(xx, ww, bb):
        return jnp.sum(jax.vmap(lambda v, p, q: j_bsr_fused_rhs(
            ja, jat, v, p, q))(xx, ww, bb) * g)

    xt = torch.as_tensor(x).requires_grad_()
    y = sparse.matvec(op, xt)
    (y * torch.as_tensor(g)).sum().backward()
    _close(y.detach(), jax.vmap(lambda v: j_bsr_spmm(ja, jat, v))(x))
    _close(xt.grad, jax.grad(j_k3)(jnp.asarray(x)))
    ins = [torch.as_tensor(x).requires_grad_(),
           torch.as_tensor(np.ascontiguousarray(w.transpose(0, 2, 1)))
           .requires_grad_(), torch.as_tensor(b).requires_grad_()]
    out = bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, ins[0],
                                 ins[1].transpose(-1, -2), ins[2])
    _close(out.detach(), jax.vmap(lambda v, p, q: j_bsr_fused_rhs(
        ja, jat, v, p, q))(x, w, b))
    (out * torch.as_tensor(g)).sum().backward()
    want = jax.grad(j_k4, argnums=(0, 1, 2))(x, w, b)
    _close(ins[0].grad, want[0])
    _close(ins[1].grad.transpose(-1, -2), want[1])
    _close(ins[2].grad, want[2])
    for i in range(R):
        one = bsr_spmm.bsr_spmm(op.fwd, op.bwd, ins[0][i].detach())
        _close(y[i].detach(), one, 1e-6)
        _close(out[i].detach(), bsr_spmm.bsr_fused_rhs(
            op.fwd, op.bwd, ins[0][i].detach(), ins[1][i].detach().t(),
            ins[2][i].detach()), 1e-6)


def test_batched_forms_refuse_what_they_cannot_take():
    a, _ = _matrix(40, 0)
    op = from_scipy_coo(a)
    with pytest.raises(ValueError, match="R <= 65535"):
        coo_spmv.coo_spmv(op, torch.zeros(2, 3, 40, 4))
    h, w = torch.zeros(2, 40, 4), torch.zeros(2, 4, 4)
    with pytest.raises(ValueError, match="b \\(R, k\\)"):
        fused_rhs.fused_rhs(torch.zeros(40, 40), h, w, torch.zeros(4))
    bop = sparse.as_operator(a, sparse=True, format="bsr")
    with pytest.raises(ValueError, match="w \\(R, d, d\\)"):
        bsr_spmm.bsr_fused_rhs(bop.fwd, bop.bwd, h, torch.zeros(4, 4),
                               torch.zeros(2, 4))
