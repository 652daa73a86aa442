"""The mutualistic and gene dynamics of the port on the CPU, against the
torchdiffeq-oracle fixtures and the JAX package.

Bars:
- physics trajectories (``ns_{mutualistic,gene}_*`` on the adjacency each
  fixture stores, ``{mutualistic,gene}_random60_dopri5``): 1e-4 rel-L1, the
  JAX package's bar (``tests/test_parity.py``), on the dense operator and,
  for the grid and random60, on COO (K1-w's plain version; K1's for gene)
  and ELL;
- K1-w's plain version against the JAX package's ``_coo_mutual_inter``
  through its Pallas reduce in interpret mode (``_use_tiles`` patched, as
  ``tests/test_dynamics_and_models.py`` does): max|Δ|/max|y| <= 1e-5
  forward, <= 1e-4 for the gradient against ``jax.grad`` (fp32 sums in
  another order, and the Pallas kernel's split-bf16 accumulation);
- ``ndcn_grads_random60_{mutualistic,gene}`` (backprop): loss and decoder
  gradients 1e-4, the rest 2e-2, the gradient-parity floor of
  docs/PARITY.md.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.dynamics.rhs import DYNAMICS as J_DYNAMICS
from ndcn_tpu.dynamics import rhs as j_rhs
from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu_torch.convert import params_from_jax
from ndcn_tpu_torch.dynamics import (DYNAMICS, gene_dynamics, make_rhs,
                                     mutualistic_dynamics)
from ndcn_tpu_torch.experiments.dynamics import build_parser, run
from ndcn_tpu_torch.graph import operators
from ndcn_tpu_torch.graph.sparse import as_operator, from_scipy_coo
from ndcn_tpu_torch.kernels import coo_mutual, coo_spmv
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.ode import odeint_with_stats
from ndcn_tpu_torch.train.losses import l1_loss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
LAYERS = ("enc1", "enc2", "wt", "dec")
NETS = ("grid", "random", "power_law", "small_world", "community")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The solves here are thousands of small tensor operations: one thread
    runs them faster than a pool that shares the cores with other test
    processes (the file took 17 minutes under six pytest-xdist workers
    with the default pool, 45 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(name):
    return dict(np.load(os.path.join(FIX, name + ".npz")))


def rel_l1(a, b):
    """mean |a - b| / mean |b|, as ``tests/test_parity.py`` (for gradients
    the sum form of ``tests/test_gradients.py``, the same ratio)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-12))


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _physics(name, dyn, fmt):
    f = load(name)
    op = as_operator(f["adj"] if fmt == "dense" else sp.csr_matrix(f["adj"]),
                     sparse=fmt != "dense", format=fmt)
    sol, stats = odeint_with_stats(make_rhs(dyn, op), torch.as_tensor(f["x0"]),
                                   f["t"], rtol=1e-7, atol=1e-9,
                                   method="dopri5",
                                   options={"differentiable": False})
    assert stats.success
    return rel_l1(sol, f["sol"])


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("dyn", ["mutualistic", "gene"])
def test_north_star_physics_matches_the_oracle(dyn, net):
    """The reference's ground truth on its five 400-node graphs (the stored
    adjacency; the port's generators have the grid only), dense."""
    assert _physics(f"ns_{dyn}_{net}", dyn, "dense") < 1e-4


FORMAT_CASES = [(f"{dyn}_random60_dopri5", dyn, fmt)
                for dyn in ("mutualistic", "gene")
                for fmt in ("dense", "coo", "ell")] + [
                   (f"ns_{dyn}_grid", dyn, fmt)
                   for dyn in ("mutualistic", "gene") for fmt in ("coo", "ell")]


@pytest.mark.parametrize("fixture,dyn,fmt", FORMAT_CASES)
def test_physics_matches_the_oracle_on_every_format(fixture, dyn, fmt):
    """The 60-node random graph on every format, and the 400-node grid on
    the sparse ones (its dense case is above)."""
    assert _physics(fixture, dyn, fmt) < 1e-4


def _asymmetric(kind):
    """An asymmetric 60-node graph with zero diagonal, as the JAX package's
    COO test; or a 600-node one whose row 3 has 400 edges (a split row) and
    whose column 5 gathers 300 (a split row of the transpose)."""
    rng = np.random.RandomState(0)
    if kind == "asym60":
        n = 60
        dense = (rng.rand(n, n) * (rng.rand(n, n) < 0.2)).astype(np.float32)
        np.fill_diagonal(dense, 0)
        return sp.csr_matrix(dense)
    n = 600
    rows = np.concatenate([rng.randint(0, n, 3000), np.full(400, 3),
                           rng.choice(n, 300, replace=False)])
    cols = np.concatenate([rng.randint(0, n, 3000),
                           rng.choice(n, 400, replace=False),
                           np.full(300, 5)])
    a = sp.coo_matrix((rng.rand(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


@pytest.mark.parametrize("graph", ["asym60", "hub"])
@pytest.mark.parametrize("d", [1, 5])
@pytest.mark.parametrize("convention", ["reference", "paper"])
def test_k1w_plain_matches_the_pallas_reduce(monkeypatch, convention, d,
                                             graph):
    """K1-w's plain version (the CPU path of ``coo_mutual_inter``) against
    the JAX package's tiled interaction in interpret mode, forward and
    gradient; the convention's swap of e and h, as ``mutualistic_dynamics``
    applies it at entry; the whole RHS too."""
    monkeypatch.setattr(j_rhs, "_use_tiles", lambda op: op.tiles is not None)
    a = _asymmetric(graph)
    n = a.shape[0]
    op = from_scipy_coo(a)
    if graph == "hub":
        assert op.split.long_rows.numel() and op.split_t.long_rows.numel()
    j_op = j_from_scipy_coo(a, tiled=True)
    rng = np.random.RandomState(d)
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
    assert max_rel(y.detach(), y_j) <= 1e-5
    assert max_rel(g, g_j) <= 1e-4

    rhs_j = np.asarray(j_rhs.mutualistic_dynamics(j_op, 0.0, jnp.asarray(x),
                                                  convention=convention))
    rhs = mutualistic_dynamics(op, 0.0, torch.as_tensor(x),
                               convention=convention)
    assert max_rel(rhs, rhs_j) <= 1e-5


def test_k1w_plain_backward_is_explicit_and_poisons_the_operator():
    """The twin's backward (explicit formulas) equals autograd of its
    forward, and a gradient asked of the operator's values is NaN."""
    a = _asymmetric("asym60")
    op = from_scipy_coo(a)
    rng = np.random.RandomState(3)
    x = torch.as_tensor((rng.rand(60, 5) * 3 + 0.2).astype(np.float32)
                        ).requires_grad_()
    g = torch.as_tensor(rng.randn(60, 5).astype(np.float32))
    (dx,) = torch.autograd.grad(
        (coo_mutual.coo_mutual_inter_plain(op, x, 5.0, 0.1, 0.9) * g).sum(),
        x)
    (ref,) = torch.autograd.grad(
        (coo_mutual.mutual_forward_plain(op, x, 5.0, 0.1, 0.9) * g).sum(), x)
    assert max_rel(dx, ref) <= 1e-6
    vals = op.vals.clone().requires_grad_()
    op_v = op._replace(vals=vals)
    y = coo_mutual.coo_mutual_inter(op_v, x.detach(), 5.0, 0.1, 0.9)
    (dv,) = torch.autograd.grad(y.sum(), vals)
    assert torch.isnan(dv).all()
    assert coo_mutual.LAUNCHES == 0        # the CPU never counts a launch


def test_ground_truth_step_count_follows_the_sum_order(monkeypatch):
    """The 5,000-node mutualistic ground truth of ``chip_smoke.py`` [14]
    (rtol 1e-6, atol 1e-8): the interaction summed in another order, or in
    float64 and rounded once, moves the trajectory by ~2e-7 rel-L1 and may
    add a rejected attempt (644 against 650 evaluations here). So the card's
    K1-w, whose sums run in its own order, is held to the CPU's answer at
    1e-4 and to its step count within 2 %, not to an equal count."""
    from ndcn_tpu_torch.experiments.dynamics import ground_truth
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.train.sampling import sample_times

    op = from_scipy_coo(build_sparse_graph(5_000, 10, seed=0))
    x0 = torch.as_tensor(np.random.RandomState(0).uniform(
        0.0, 25.0, (5_000, 1)).astype(np.float32))
    t = sample_times(5.0, 40, "irregular", seed=0).t
    plain = coo_mutual.mutual_forward_plain

    def float64_sum(op, x, d, e, h):
        return plain(op._replace(vals=op.vals.double()), x.double(), d, e,
                     h).float()

    def reversed_sum(op, x, d, e, h):
        flip = op._replace(rows=op.rows.flip(0), cols=op.cols.flip(0),
                           vals=op.vals.flip(0))
        return plain(flip, x, d, e, h)

    def solve():
        sol, stats = ground_truth("mutualistic", op, x0, t, rtol=1e-6,
                                  atol=1e-8)
        assert stats.success
        return sol, stats.nfe

    base, nfe = solve()
    nfes = {nfe}
    for fwd in (float64_sum, reversed_sum):
        monkeypatch.setattr(coo_mutual, "mutual_forward_plain", fwd)
        sol, other = solve()
        assert rel_l1(sol, base) < 1e-6
        assert abs(other - nfe) <= 0.02 * nfe
        nfes.add(other)
    assert len(nfes) > 1, nfes


def test_gene_on_coo_is_never_rounded_at_width_one(monkeypatch):
    """The gene coupling is K1 (``matvec``); a width-1 state is not rounded
    to bf16 even under ``GATHER_BF16``, as in the JAX package."""
    f = load("gene_random60_dopri5")
    op = as_operator(sp.csr_matrix(f["adj"]), sparse=True, format="coo")
    x = torch.as_tensor(f["sol"][7])
    ref = gene_dynamics(op, 0.0, x)
    monkeypatch.setattr(coo_spmv, "GATHER_BF16", True)
    assert torch.equal(gene_dynamics(op, 0.0, x), ref)


def test_make_rhs_and_its_refusals():
    assert DYNAMICS == J_DYNAMICS
    op = as_operator(sp.csr_matrix(load("gene_random60_dopri5")["adj"]),
                     sparse=True, format="bsr")
    x = torch.ones(60, 1)
    assert make_rhs("gene", op)(0.0, x).shape == (60, 1)
    with pytest.raises(ValueError, match="BSR"):
        make_rhs("mutualistic", op)(0.0, x)
    with pytest.raises(ValueError, match="convention"):
        mutualistic_dynamics(op, 0.0, x, convention="other")
    with pytest.raises(ValueError, match="unknown dynamics"):
        make_rhs("lv", op)


@pytest.mark.parametrize("dyn", ["mutualistic", "gene"])
def test_ndcn_gradients_match_the_oracle_per_dynamics(dyn):
    """The flagship l1 loss on random60 against the reference's
    ``loss.backward()`` at the fixture's weights (backprop mode)."""
    f = load(f"ndcn_grads_random60_{dyn}")
    model = params_from_jax({name: {"w": f[f"{name}_w"].T,
                                    "b": f[f"{name}_b"]} for name in LAYERS})
    op = as_operator(operators.normalized_laplacian(f["adj"]))
    out, stats = ndcn_forward(model, op, f["t"], torch.as_tensor(f["x0"]),
                              rtol=0.01, atol=0.001, method="dopri5",
                              max_steps=64)
    loss = l1_loss(out[..., 0].T, torch.as_tensor(f["target"]))
    loss.backward()
    assert stats.success
    ref = float(f["loss_backprop"])
    assert abs(loss.item() - ref) / abs(ref) < 1e-4
    for name in LAYERS:
        tol = 1e-4 if name == "dec" else 2e-2
        layer = getattr(model, name)
        assert rel_l1(layer.weight.grad, f[f"g_{name}_w_backprop"]) < tol
        assert rel_l1(layer.bias.grad, f[f"g_{name}_b_backprop"]) < tol


def test_mutualistic_experiment_takes_coo_physics_for_bsr(capsys):
    """The driver on BSR: the model's operator is BSR, the mutualistic
    physics COO, with the JAX driver's printed line; the loss is finite."""
    out = run("mutualistic", build_parser("t").parse_args(
        ["--n", "36", "--time_tick", "8", "--niters", "2", "--test_freq",
         "2", "--method", "dopri5", "--max_steps", "32", "--platform", "cpu",
         "--sparse", "--sparse_format", "bsr"]))
    assert np.isfinite(out["final"]["abs_error"])
    assert "using COO for the ground-truth operator" in capsys.readouterr().out
