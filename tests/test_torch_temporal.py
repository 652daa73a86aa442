"""The temporal-GNN baselines of the port against the JAX package: the
recurrent cells, ``temporal_gcn_forward`` on every operator format, the
weights' round trip through ``convert``, the dynamics driver's temporal
loss and rollout, and the parameter counts.

Bars: the cells and the forward within 1e-5 max|Δ| / max|y| of the JAX
package's at the same weights, gradients within 1e-4 rel-L1 of
``jax.grad`` (the same float32 program, sums in another order). The port's
dense, COO, BSR and ELL forwards are held against JAX's dense forward, and
COO once more against JAX's COO forward through the Pallas sliced-tile
kernel in interpret mode, at the same bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu.graph import generators as j_generators
from ndcn_tpu.graph import operators as j_operators
from ndcn_tpu.graph import sparse as j_sparse
from ndcn_tpu.models import init_temporal_gcn as j_init_temporal_gcn
from ndcn_tpu.models import nn as j_nn
from ndcn_tpu.models import temporal_gcn_forward as j_temporal_gcn_forward
from ndcn_tpu_torch.convert import model_from_jax, model_to_jax
from ndcn_tpu_torch.experiments.dynamics import (build_parser, ground_truth,
                                                 run)
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import init_temporal_gcn, temporal_gcn_forward
from ndcn_tpu_torch.models import nn as t_nn
from ndcn_tpu_torch.train.checkpoint import save_checkpoint
from ndcn_tpu_torch.train.sampling import sample_times

RNN_TYPES = ("lstm", "gru", "rnn")
FORMATS = {"dense": dict(sparse=False), "coo": dict(sparse=True, format="coo"),
           "bsr": dict(sparse=True, format="bsr"),
           "ell": dict(sparse=True, format="ell")}
N, T, FUTURE = 25, 6, 3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one thread beats a pool that shares the
    cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def as_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def kipf():
    """The 25-node grid's Kipf operator, an input sequence and a
    cotangent."""
    adj = generators.build_network("grid", N)
    rs = np.random.RandomState(0)
    return dict(adj=adj, op=operators.zipf_smoothing(adj),
                x=rs.rand(N, T).astype(np.float32),
                g=rs.randn(N, T + FUTURE).astype(np.float32))


def jax_reference(kipf, rnn_type, j_op):
    """JAX's forward and ``jax.grad`` of sum(out * g) at the seed-0 init."""
    params = j_init_temporal_gcn(jax.random.PRNGKey(0), 1, 5, N, 10,
                                 rnn_type)
    x, g = jnp.asarray(kipf["x"]), jnp.asarray(kipf["g"])

    def loss(p):
        out = j_temporal_gcn_forward(p, j_op, x, rnn_type=rnn_type,
                                     future=FUTURE)
        return jnp.sum(out * g), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return as_numpy_tree(params), np.asarray(out), as_numpy_tree(grads)


@pytest.fixture(scope="module")
def dense_refs(kipf):
    j_op = j_sparse.as_operator(kipf["op"])
    return {r: jax_reference(kipf, r, j_op) for r in RNN_TYPES}


def port_forward(kipf, rnn_type, params, op):
    model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, N, 10,
                              rnn_type)
    model_from_jax(params, model)
    out = temporal_gcn_forward(model, op, torch.as_tensor(kipf["x"]),
                               rnn_type, future=FUTURE)
    (out * torch.as_tensor(kipf["g"])).sum().backward()
    tree = model.jax_tree()
    grads = {"gc": {"w": tree["gc"].weight.grad.numpy().T,
                    "b": tree["gc"].bias.grad.numpy()},
             "out": {"w": tree["out"].weight.grad.numpy().T,
                     "b": tree["out"].bias.grad.numpy()},
             "cell": {k: v.grad.numpy() for k, v in tree["cell"].items()}}
    return out.detach().numpy(), grads


def check_against(ref, got):
    _, out_ref, grads_ref = ref
    out, grads = got
    assert out.shape == (N, T + FUTURE)
    assert max_rel(out, out_ref) <= 1e-5
    flat_ref = jax.tree_util.tree_leaves_with_path(grads_ref)
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, want in flat_ref:
        assert rel_l1(flat[path], want) <= 1e-4, path


@pytest.mark.parametrize("rnn_type", RNN_TYPES)
def test_cells_match_jax_at_the_same_weights(rnn_type):
    """Each cell's output (and LSTM's cell state) and its gradients against
    the JAX package's cell."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 7).astype(np.float32)
    h = rs.randn(3, 10).astype(np.float32)
    c = rs.randn(3, 10).astype(np.float32)
    jp = as_numpy_tree(j_nn.rnn_cell_init(jax.random.PRNGKey(2), 7, 10,
                                          gates=j_nn.RNN_GATES[rnn_type]))
    cell = t_nn.rnn_cell_init(7, 10, rnn_type,
                              generator=torch.Generator().manual_seed(0))
    assert cell.gates == t_nn.RNN_GATES[rnn_type]
    with torch.no_grad():
        for k, v in jp.items():
            getattr(cell, k).copy_(torch.tensor(v))

    def j_apply(p, x):
        if rnn_type == "lstm":
            hn, cn = j_nn.lstm_cell_apply(p, x, (h, c))
            return jnp.concatenate([hn, cn], -1)
        fn = j_nn.gru_cell_apply if rnn_type == "gru" else j_nn.rnn_cell_apply
        return fn(p, x, h)

    ref, vjp = jax.vjp(jax.jit(j_apply), jp, jnp.asarray(x))
    g = rs.randn(*ref.shape).astype(np.float32)
    g_params, g_x = vjp(jnp.asarray(g))

    xt = torch.as_tensor(x).requires_grad_()
    if rnn_type == "lstm":
        out = torch.cat(cell(xt, (torch.as_tensor(h), torch.as_tensor(c))),
                        -1)
    else:
        out = cell(xt, torch.as_tensor(h))
    (out * torch.as_tensor(g)).sum().backward()
    assert max_rel(out.detach(), ref) <= 1e-5
    assert rel_l1(xt.grad, g_x) <= 1e-4
    for k, v in g_params.items():
        assert rel_l1(getattr(cell, k).grad, v) <= 1e-4, k


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("rnn_type", RNN_TYPES)
def test_forward_and_gradients_match_jax(kipf, dense_refs, rnn_type, fmt):
    """``future`` 3 on the 25-node grid, T = 6: the port on each operator
    format against JAX's dense forward and ``jax.grad``."""
    ref = dense_refs[rnn_type]
    op = as_operator(kipf["op"], **FORMATS[fmt])
    check_against(ref, port_forward(kipf, rnn_type, ref[0], op))


def test_coo_forward_matches_jax_pallas_interpret(kipf, monkeypatch):
    """The port's COO forward (K1's plain version) against JAX's COO
    forward through the Pallas sliced-tile kernel in interpret mode."""
    monkeypatch.setattr(j_sparse, "use_tiled_kernel", lambda: True)
    j_op = j_sparse.from_scipy_coo(sp.csr_matrix(kipf["op"]), tiled=True)
    assert j_op.tiles is not None
    ref = jax_reference(kipf, "lstm", j_op)
    check_against(ref, port_forward(kipf, "lstm", ref[0],
                                    as_operator(kipf["op"],
                                                **FORMATS["coo"])))


@pytest.mark.parametrize("rnn_type", RNN_TYPES)
def test_convert_round_trip_is_bit_equal(rnn_type):
    """JAX's ``init_temporal_gcn`` tree into the port and back, bit for
    bit, with the torch cells' layout."""
    tree = as_numpy_tree(j_init_temporal_gcn(jax.random.PRNGKey(3), 1, 5,
                                             N, 10, rnn_type))
    model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, N, 10,
                              rnn_type)
    model_from_jax(tree, model)
    g = 10 * t_nn.RNN_GATES[rnn_type]
    assert tuple(model.cell.w_ih.shape) == (g, N * 5)
    assert tuple(model.cell.w_hh.shape) == (g, 10)
    back = model_to_jax(model)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        model_from_jax(as_numpy_tree(j_init_temporal_gcn(
            jax.random.PRNGKey(3), 1, 5, N + 1, 10, rnn_type)), model)


@pytest.mark.parametrize("rnn_type", RNN_TYPES)
def test_driver_loss_and_rollout_follow_jax_formula(rnn_type, tmp_path):
    """The heat driver's temporal train loss (one step ahead over the train
    grid) and test error (teacher-force the train grid, roll out the
    extrapolation steps, score the trailing columns) at JAX's weights: the
    weights enter through a checkpoint one iteration before the end, and
    Adam at lr 0 keeps them for the final evaluation."""
    argv = ["--n", str(N), "--time_tick", "10", "--baseline",
            f"{rnn_type}_gnn", "--niters", "2", "--test_freq", "2", "--lr",
            "0", "--weight_decay", "0", "--ckpt_dir", str(tmp_path),
            "--ckpt_freq", "1000", "--platform", "cpu"]
    args = build_parser("t").parse_args(argv)
    adj = generators.build_network("grid", N)
    tree = as_numpy_tree(j_init_temporal_gcn(jax.random.PRNGKey(4), 1, 5, N,
                                             10, rnn_type))
    model = init_temporal_gcn(torch.Generator().manual_seed(0), 1, 5, N, 10,
                              rnn_type)
    save_checkpoint(str(tmp_path), 1, model_from_jax(tree, model))
    out = run("heat", args)

    splits = sample_times(args.T, args.time_tick, "irregular", seed=0)
    x0 = generators.grid_block_initial_value(5)[:N].astype(np.float32)
    sol, _ = ground_truth("heat", as_operator(operators.laplacian_dense(adj)),
                          torch.as_tensor(x0), splits.t)
    true_y = jnp.asarray(sol[..., 0].T.numpy())
    y_train = true_y[:, splits.id_train]
    y_test = true_y[:, splits.id_test]
    j_op = j_sparse.as_operator(j_operators.zipf_smoothing(
        j_generators.build_network("grid", N)))
    forward = jax.jit(j_temporal_gcn_forward,
                      static_argnames=("rnn_type", "future"))
    pred = forward(tree, j_op, y_train[:, :-1], rnn_type=rnn_type)
    want_train = float(jnp.mean(jnp.abs(pred - y_train[:, 1:])))
    roll = forward(tree, j_op, y_train, rnn_type=rnn_type,
                   future=len(splits.id_test))
    want_test = float(jnp.mean(jnp.abs(roll[:, -len(splits.id_test):]
                                       - y_test)))
    assert abs(out["final"]["train_loss"] - want_train) <= 1e-5 * want_train
    assert abs(out["final"]["abs_error"] - want_test) <= 1e-5 * want_test
    assert out["final"]["rel_error"] == pytest.approx(
        want_test / float(jnp.mean(y_test)), rel=1e-5)
    assert out["final"]["abs_error2"] == 0.0 and out["max_steps"] == 0


@pytest.mark.parametrize("rnn_type,count", [("lstm", 84_890), ("gru", 64_770),
                                            ("rnn", 24_530)])
def test_parameter_counts_at_400_nodes(rnn_type, count):
    """The driver's printed count at n = 400 is the JAX package's."""
    tree = j_init_temporal_gcn(jax.random.PRNGKey(0), 1, 5, 400, 10, rnn_type)
    assert sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(tree)) == count
    out = run("heat", build_parser("t").parse_args(
        ["--baseline", f"{rnn_type}_gnn", "--niters", "0", "--platform",
         "cpu"]))
    assert out["n_params"] == count
