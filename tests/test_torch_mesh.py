"""The node-sharded mesh path of the port (``ndcn_tpu_torch.parallel``)
against the JAX package's (``ndcn_tpu.parallel``).

- ``mesh_shape`` against JAX's ``make_mesh`` over a table of device
  counts and divisibility constraints, and the loud error;
- the row blocks of ``shard_coo_rows`` against ``_pack_row_blocks``'s
  triplets, and K1 on each row block concatenating bit-equal to the whole
  product (the plain versions here);
- one spawn of 4 gloo ranks (``parallel.dryrun``, each rank a process of
  its own that imports neither JAX nor pytest) whose arrays are held
  against the JAX package on conftest's virtual CPU mesh: the row-sharded
  matvec forward and gradient against ``_rs_coo_matvec`` and against the
  Pallas ``_rs_tiled_apply`` in interpret mode, feature-major against
  ``rs_spmv_T``, a dense and a COO dopri5 train step against the
  unsharded JAX step's loss and ``jax.grad`` (ROADMAP's 1e-4 / 1e-3; the
  sharded-vs-unsharded parity is 1e-5, checked on every rank), equal NFE
  and bit-equal parameters on every rank; the same spawn lays the 4 ranks
  out 2 x 2 (data, model) for a replica sweep held against ``jax.vmap``;
  on the model axis of 4, the continuous adjoint against JAX's
  ``odeint_adjoint`` gradients, an lstm_gnn step with dropout against
  ``jax.grad`` of JAX's ``temporal_gcn_forward`` on the same dropped
  inputs, and GCN, DeepGCN2 and DeepGCN3 against the JAX zoo (logits and
  ``jax.grad``), the parameters after those steps bit-equal on every rank;
- ``ode.tree_math`` holds no process group and the solvers import nothing
  of ``parallel``: the group is the solve's option, and a replicated
  leaf's norm takes no collective;
- the drivers with ``--mesh`` on a world of one: the scale driver on a
  one-rank gloo group (``mesh_devices`` 1, parity < 1e-4, the losses of
  the run without ``--mesh``), the dynamics and dgnn drivers' notice and
  their unsharded losses; on two gloo ranks every driver path the JAX
  drivers shard, the adjoint, the temporal baselines and the GCN zoo
  included, prints the unsharded run's losses;
- the device rules: the dryrun refuses fewer cards than ranks, and the
  drivers take torchrun's ``LOCAL_RANK``-th card.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ndcn_tpu_torch.parallel import dryrun
from ndcn_tpu_torch.parallel.mesh import mesh_shape, node_range


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the in-process solves are many small tensor
    operations, and the spawned ranks already share the cores with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    return dryrun.rel_l1([a], [b])


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,data_divides,model_divides", [
    (1, None, None), (2, None, None), (4, None, None), (6, None, None),
    (8, None, None), (8, 2, None), (8, 1, 2708), (8, 25, 2708), (8, 8, None),
    (8, 3, 7), (8, 3, 11), (4, 1, 502), (4, 1, 500), (6, 1, 9), (5, 1, None),
])
def test_mesh_shape_matches_jax(n, data_divides, model_divides):
    from ndcn_tpu.parallel.mesh import make_mesh

    ref = make_mesh(n, data_divides=data_divides, model_divides=model_divides)
    assert mesh_shape(n, data_divides, model_divides) == \
        tuple(ref.devices.shape)


def test_mesh_shape_too_few_ranks_is_loud():
    from ndcn_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_shape(8, available=4)
    with pytest.raises(ValueError):
        make_mesh(len(jax.devices()) + 1)


@pytest.mark.parametrize("n,p", [(502, 4), (500, 4), (7, 4), (3, 4), (9, 1)])
def test_node_range_partitions_rows(n, p):
    ranges = [node_range(n, p, r) for r in range(p)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 <= b - a <= -(-n // p) for a, b in ranges)


def test_replica_range_splits_the_data_axis():
    from ndcn_tpu_torch.parallel.mesh import Mesh, replica_range

    meshes = [Mesh(data=4, model=2, data_rank=r, model_rank=0,
                   data_group=None, model_group=None, device_mesh=None)
              for r in range(4)]
    assert [replica_range(m, 8) for m in meshes] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        replica_range(meshes[0], 6)


# ------------------------------------------------------------ row blocks
@pytest.mark.parametrize("transpose", [False, True])
def test_shard_coo_rows_matches_pack_row_blocks(transpose):
    """Each rank's block of A (of Aᵀ) holds _pack_row_blocks's triplets of
    its rows, in order, without the zero-valued pad edges."""
    from ndcn_tpu.graph.sparse import from_scipy_coo as jax_coo
    from ndcn_tpu.parallel.coo_shard import _pack_row_blocks

    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    mat, _ = dryrun.spmv_problem()
    p, n = 4, mat.shape[0]
    rows_per = -(-n // p)
    ref = jax_coo(mat)
    triplets = ((ref.rows_t, ref.cols_t, ref.vals_t) if transpose
                else (ref.rows, ref.cols, ref.vals))
    lr, cc, vv = _pack_row_blocks(*(np.asarray(a) for a in triplets), p,
                                  rows_per)
    coo = from_scipy_coo(mat)
    for r in range(p):
        rs = shard_coo_at(coo, p, r, None)
        block = rs.block_t if transpose else rs.block
        assert (rs.start, rs.stop, rs.rows_per, rs.n_pad) == (
            *node_range(n, p, r), rows_per, p * rows_per)
        rows, cols, vals = (t.numpy() for t in (block.rows, block.cols,
                                                block.vals))
        k = rows.size
        np.testing.assert_array_equal(rows, lr[r, :k])
        np.testing.assert_array_equal(cols, cc[r, :k])
        np.testing.assert_array_equal(vals, vv[r, :k])
        assert not vv[r, k:].any()
        assert block.row_ptr.shape == (rows_per + 1,)


@pytest.mark.parametrize("bf16", [False, True])
def test_row_block_products_concatenate_to_the_whole(bf16):
    """K1, K1ᵀ and K1-fm on each of 4 row blocks (the hub row cut into
    chunks within its block) against the gathered table, concatenated:
    bit-equal to the whole operator's product."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.kernels import coo_spmv
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    mat, x_np = dryrun.spmv_problem()
    coo = from_scipy_coo(mat)
    p, n = 4, coo.n
    x = torch.as_tensor(x_np)
    xT = torch.zeros((8, n))
    xT[:x.shape[1]] = x.t()
    with coo_spmv.gather_precision(bf16):
        blocks = [shard_coo_at(coo, p, r, None) for r in range(p)]
        assert any(b.block.split.long_rows.numel() for b in blocks)
        n_pad = blocks[0].n_pad
        table = torch.cat([x, x.new_zeros((n_pad - n, x.shape[1]))])
        packed = torch.cat([coo_spmv.pack_rows(xT, bf16),
                            torch.zeros((n_pad - n, 8),
                                        dtype=torch.bfloat16 if bf16
                                        else torch.float32)])
        for transpose in (False, True):
            whole_op = coo.transpose() if transpose else coo
            parts = [b.block_t if transpose else b.block for b in blocks]
            y = torch.cat([coo_spmv._apply(bl, table)[:b.stop - b.start]
                           for bl, b in zip(parts, blocks)])
            assert torch.equal(y, coo_spmv._apply(whole_op, x))
            yT = torch.cat([coo_spmv.gather_T(bl, packed)[:, :b.stop - b.start]
                            for bl, b in zip(parts, blocks)], dim=1)
            assert torch.equal(yT, coo_spmv._apply_T(whole_op, xT))


def test_row_block_batched_products_match_each_replica():
    """R replicas' states through K1's batched form on each row block (the
    table of n_pad rows, the output of rows_per): each replica equals its
    own block product, and the blocks concatenate to the whole batched
    product."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.kernels import coo_spmv
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    mat, x_np = dryrun.spmv_problem()
    coo = from_scipy_coo(mat)
    x = torch.as_tensor(np.stack([x_np, 2 * x_np[::-1], -x_np]))
    blocks = [shard_coo_at(coo, 4, r, None) for r in range(4)]
    table = torch.cat([x, x.new_zeros((3, blocks[0].n_pad - coo.n, 5))], 1)
    parts = []
    for b in blocks:
        coo_spmv._check(b.block, table, batched=True)
        y = coo_spmv._apply(b.block, table)
        assert y.shape == (3, b.rows_per, 5)
        for i in range(3):
            assert torch.equal(y[i], coo_spmv._apply(b.block, table[i]))
        parts.append(y[:, :b.stop - b.start])
    assert torch.equal(torch.cat(parts, 1), coo_spmv._apply(coo, x))


def test_one_rank_sharded_product_keeps_only_the_operator():
    """A group of one: the sharded product equals the whole product bit for
    bit, forward and backward, and puts no tensor on the tape (JAX's
    _rst_fwd saves only the operator)."""
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo, matvec
    from ndcn_tpu_torch.parallel.coo_shard import shard_coo_at

    mat, x_np = dryrun.spmv_problem()
    coo = from_scipy_coo(mat)
    rs = shard_coo_at(coo, 1, 0, None)
    saved = []
    x = torch.as_tensor(x_np).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = matvec(rs, x)
    assert saved == []
    (y * y).sum().backward()
    xw = torch.as_tensor(x_np).requires_grad_()
    yw = matvec(coo, xw)
    (yw * yw).sum().backward()
    assert torch.equal(y, yw) and torch.equal(x.grad, xw.grad)


# ------------------------------------------------ four gloo ranks vs JAX
@pytest.fixture(scope="module")
def gloo4(tmp_path_factory):
    """The dryrun's checks on 4 gloo ranks; their arrays, by rank."""
    out = str(tmp_path_factory.mktemp("gloo4"))
    rc = dryrun.spawn(4, "cpu", out=out, timeout=150)
    assert rc == 0, f"the 4-rank dryrun failed (exit {rc})"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(4)]


@pytest.fixture(scope="module")
def jax_mesh4():
    from ndcn_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4, data_divides=1)
    assert tuple(mesh.devices.shape) == (1, 4)
    return mesh


def _rows(ranks, key, axis=0):
    return np.concatenate([r[key] for r in ranks], axis=axis)


@pytest.mark.parametrize("route", ["rs_coo_matvec", "rs_tiled_apply"])
def test_gloo_matvec_matches_jax(gloo4, jax_mesh4, route):
    """The 4-rank row-sharded matvec (forward, and the gradient of
    sum(y²)) against JAX's sharded matvec: the segment-sum route and the
    Pallas kernel per device (interpret mode). ROADMAP's 1e-4 / 1e-3."""
    import unittest.mock as mock

    from ndcn_tpu.graph import sparse as gs
    from ndcn_tpu.graph.sparse import from_scipy_coo, matvec
    from ndcn_tpu.parallel.coo_shard import shard_coo_rows

    mat, x_np = dryrun.spmv_problem()
    x = jnp.asarray(x_np)
    tiled = route == "rs_tiled_apply"
    with jax_mesh4:
        rs = shard_coo_rows(from_scipy_coo(mat, tiled=tiled), jax_mesh4,
                            tiled=tiled)
        with mock.patch.object(gs, "use_tiled_kernel", lambda: tiled):
            y = matvec(rs, x)
            g = jax.grad(lambda xx: jnp.sum(matvec(rs, xx) ** 2))(x)
    assert _rel(_rows(gloo4, "coo_y"), np.asarray(y)) <= 1e-4
    assert _rel(_rows(gloo4, "coo_dx"), np.asarray(g)) <= 1e-3


def test_gloo_feature_major_matches_jax(gloo4, jax_mesh4):
    """rs_spmv_T on 4 gloo ranks (K1-fm's pack, the all-gathered table,
    the gather on each row block) against JAX's rs_spmv_T (the Pallas
    kernel per device, interpret mode), forward and gradient."""
    from ndcn_tpu.graph.sparse import from_scipy_coo
    from ndcn_tpu.parallel.coo_shard import rs_spmv_T, shard_coo_rows

    mat, x_np = dryrun.spmv_problem()
    xT = np.zeros((8, mat.shape[0]), np.float32)
    xT[:x_np.shape[1]] = x_np.T
    with jax_mesh4:
        rs = shard_coo_rows(from_scipy_coo(mat, tiled=True), jax_mesh4,
                            tiled=True)
        y = rs_spmv_T(rs, jnp.asarray(xT))
        g = jax.grad(lambda v: jnp.sum(rs_spmv_T(rs, v) ** 2))(
            jnp.asarray(xT))
    assert _rel(_rows(gloo4, "fm_y", 1), np.asarray(y)) <= 1e-4
    assert _rel(_rows(gloo4, "fm_dx", 1), np.asarray(g)) <= 1e-3


@pytest.mark.parametrize("tag", ["dense", "coo"])
def test_gloo_train_step_matches_jax(gloo4, tag):
    """The 4-rank dopri5 train step (dense rows through torch.matmul, or
    K1 on the COO row blocks) against the unsharded JAX step at the same
    weights: the loss within 1e-4, every gradient within 1e-3 rel-L1."""
    from ndcn_tpu.graph.sparse import from_dense, from_scipy_coo
    from ndcn_tpu.models import ndcn_forward

    pb = dryrun.train_problem()
    r0 = gloo4[0]
    params = {}
    for key, v in r0.items():
        parts = key.split("/")
        if parts[:2] == [tag, "init"]:
            params.setdefault(parts[2], {})[parts[3]] = jnp.asarray(v)
    op = (from_dense(pb["lap"].toarray()) if tag == "dense"
          else from_scipy_coo(pb["lap"]))

    def loss_fn(p):
        out, _ = ndcn_forward(p, op, jnp.asarray(pb["vt"]),
                              jnp.asarray(pb["x0"]), method="dopri5",
                              max_steps=64)
        return jnp.mean(jnp.abs(out - jnp.asarray(pb["target"])))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert abs(float(r0[f"{tag}/loss"]) - float(loss)) <= 1e-4 * abs(
        float(loss))
    for layer, leaves in grads.items():
        for k, g in leaves.items():
            assert _rel(r0[f"{tag}/grad/{layer}/{k}"], np.asarray(g)) \
                <= 1e-3, (layer, k)


def test_gloo_replica_sweep_matches_jax_vmap(gloo4):
    """The dryrun's replica sweep on the 2 x 2 (data, model) mesh (K1's
    batched form on the row blocks): every replica's loss within 1e-4 of
    ``jax.vmap`` of the JAX loss at the same weights (the gradients are
    held against the unsharded port's on every rank, 1e-5, and the port's
    replica step against ``jax.vmap`` in test_torch_replicas.py); every
    rank holds every replica's loss and parameters."""
    from ndcn_tpu.graph.sparse import from_scipy_coo
    from ndcn_tpu.models import ndcn_forward

    pb = dryrun.train_problem()
    r0 = gloo4[0]
    params = {}
    for key, v in r0.items():
        parts = key.split("/")
        if parts[:2] == ["replicas", "init"]:
            params.setdefault(parts[2], {})[parts[3]] = jnp.asarray(v)
    op = from_scipy_coo(pb["lap"])

    def loss_fn(p):
        out, _ = ndcn_forward(p, op, jnp.asarray(pb["vt"]),
                              jnp.asarray(pb["x0"]), method="dopri5",
                              max_steps=64)
        return jnp.mean(jnp.abs(out - jnp.asarray(pb["target"])))

    losses = jax.vmap(loss_fn)(params)
    assert r0["replicas/loss"].shape == (4,)
    np.testing.assert_allclose(r0["replicas/loss"], np.asarray(losses),
                               rtol=1e-4)
    for r in gloo4[1:]:
        assert np.array_equal(r["replicas/loss"], r0["replicas/loss"])
        assert np.array_equal(r["replicas/params_after"],
                              r0["replicas/params_after"])


def test_gloo_ranks_agree(gloo4):
    """Every rank took the same steps (NFE) and holds the same parameters
    after them, bit for bit; each rank's loss is the whole loss."""
    for r in gloo4[1:]:
        for key in ("dense/nfe", "coo/nfe", "dense/loss", "coo/loss"):
            assert r[key] == gloo4[0][key], key
        assert np.array_equal(r["params_after"], gloo4[0]["params_after"])
    assert _rel(gloo4[0]["dense/loss"],
                gloo4[0]["dense_unsharded/loss"]) <= 1e-5


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _held_to(r0, prefix, grads, bar):
    """Every leaf of the JAX gradient tree ``grads`` against the dryrun's
    saved gradient under ``prefix`` (rel-L1 <= bar)."""
    want = dryrun.flat_tree(jax.tree_util.tree_map(np.asarray, grads),
                            prefix)
    assert want
    for key, g in want.items():
        assert _rel(r0[key], g) <= bar, key


def test_gloo_adjoint_on_a_model_axis_matches_jax(gloo4):
    """The continuous adjoint on a model axis of 4 (COO, dopri5; the
    augmented solve's parameter VJPs summed over the ranks) against JAX's
    ``odeint_adjoint`` at the same weights: the loss within 1e-4, every
    gradient within 1e-3 rel-L1 (1e-4 of the port's unsharded adjoint and
    equal forward and backward NFE are the dryrun's own checks); not 4
    times larger."""
    from ndcn_tpu.graph.sparse import from_scipy_coo
    from ndcn_tpu.models import ndcn_forward

    pb = dryrun.train_problem()
    r0 = gloo4[0]
    params = {}
    for key, v in r0.items():
        parts = key.split("/")
        if parts[:2] == ["adjoint", "init"]:
            params.setdefault(parts[2], {})[parts[3]] = jnp.asarray(v)
    op = from_scipy_coo(pb["lap"])

    def loss_fn(p):
        out, _ = ndcn_forward(p, op, jnp.asarray(pb["vt"]),
                              jnp.asarray(pb["x0"]), method="dopri5",
                              max_steps=64, adjoint=True)
        return jnp.mean(jnp.abs(out - jnp.asarray(pb["target"])))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    assert abs(float(r0["adjoint/loss"]) - float(loss)) <= 1e-4 * abs(
        float(loss))
    _held_to(r0, "adjoint/grad", grads, 1e-3)
    for r in gloo4[1:]:
        assert r["adjoint/nfe"] == r0["adjoint/nfe"]
        assert np.array_equal(r["adjoint/nfe_backward"],
                              r0["adjoint/nfe_backward"])
    assert np.array_equal(r0["adjoint/nfe_backward"],
                          r0["adjoint_unsharded/nfe_backward"])


def _dropped_inputs(series):
    """The lstm_gnn step's teacher inputs as its dropout leaves them: the
    dryrun's masks, drawn at the whole (n, 1) a step from its generator."""
    gen = torch.Generator().manual_seed(9)
    keep = 1.0 - dryrun.DROPOUT
    cols = []
    for xt in torch.as_tensor(series[:, :-1]).t():
        u = torch.rand((xt.shape[0], 1), generator=gen)
        cols.append(torch.where(u < keep, xt[:, None] / keep,
                                torch.zeros(())))
    return torch.cat(cols, dim=1).numpy()


def test_gloo_temporal_step_matches_jax(gloo4):
    """One lstm_gnn step with dropout on 4 ranks (K1's row blocks at d =
    5, the cell's input projection summed over the ranks) against
    ``jax.grad`` of JAX's ``temporal_gcn_forward`` on the same dropped
    inputs: the loss within 1e-4, gradients 1e-3 rel-L1."""
    from ndcn_tpu.graph.sparse import from_dense
    from ndcn_tpu.models.temporal_gcn import temporal_gcn_forward

    from ndcn_tpu_torch.convert import model_to_jax

    kp = dryrun.kipf_problem()
    params = _jax_tree(model_to_jax(dryrun.temporal_model()))
    op = from_dense(kp["kipf"].toarray())
    x_in = jnp.asarray(_dropped_inputs(kp["series"]))
    target = jnp.asarray(kp["series"][:, 1:])

    def loss_fn(p):
        pred = temporal_gcn_forward(p, op, x_in, "lstm")
        return jnp.mean(jnp.abs(pred - target))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    r0 = gloo4[0]
    assert abs(float(r0["temporal/loss"]) - float(loss)) <= 1e-4 * abs(
        float(loss))
    _held_to(r0, "temporal/grad", grads, 1e-3)


@pytest.mark.parametrize("name", dryrun.ZOO)
def test_gloo_zoo_matches_jax(gloo4, name):
    """GCN, DeepGCN2 (the raw features through K1's row blocks) and
    DeepGCN3 (its rows of AW ∘ A against the all-gathered state) on 4
    ranks, deterministic, against the JAX zoo at the same weights: the
    logits within 1e-5 as max|Δ| / max|y|, every gradient of the
    cross-entropy within 1e-4 rel-L1 of ``jax.grad``
    (test_torch_gcn_zoo.py's bars)."""
    from ndcn_tpu.graph.sparse import from_dense
    from ndcn_tpu.models import gcn_zoo as jz
    from ndcn_tpu.train.losses import cross_entropy

    from ndcn_tpu_torch.convert import model_to_jax

    kp = dryrun.kipf_problem()
    params = _jax_tree(model_to_jax(dryrun.zoo_model(name)))
    op = from_dense(kp["kipf"].toarray())
    x = jnp.asarray(kp["features"])
    apply = {"GCN": jz.gcn_apply, "DeepGCN2": jz.deep_gcn2_apply,
             "DeepGCN3": lambda p, o, xx: jz.deep_gcn3_apply(
                 p, o, xx, dryrun.ZOO_NHL)}[name]
    idx = jnp.asarray(kp["idx_train"])
    labels = jnp.asarray(kp["labels"])

    def loss_fn(p):
        logits = apply(p, op, x)
        return cross_entropy(logits[idx], labels[idx]), logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    got = _rows(gloo4, f"zoo/{name}/logits")
    ref = np.asarray(logits)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    r0 = gloo4[0]
    assert abs(float(r0[f"zoo/{name}/loss"]) - float(loss)) <= 1e-5 * abs(
        float(loss))
    _held_to(r0, f"zoo/{name}/grad", grads, 1e-4)


def test_gloo_model_axis_ranks_agree(gloo4):
    """After the adjoint, lstm_gnn and zoo steps every rank holds the same
    parameters, bit for bit, and the same loss."""
    r0 = gloo4[0]
    for r in gloo4[1:]:
        assert np.array_equal(r["model_axis_params_after"],
                              r0["model_axis_params_after"])
        for key in ("adjoint/loss", "temporal/loss",
                    *(f"zoo/{n}/loss" for n in dryrun.ZOO)):
            assert r[key] == r0[key], key


@pytest.mark.parametrize("method", ["dopri5", "adams", "dopri5_adjoint"])
def test_gloo_scan_chunk_matches_unsharded(gloo4, method):
    """The dryrun's check 11: a two-step ``TrainChunk`` (the bounded solve,
    dropout drawn whole, one host read) on 4 ranks' row blocks against the
    same chunk unsharded: the loss within 1e-5, every step's NFE (and each
    of the adjoint's 4 backward intervals') equal, and the parameters after
    the chunk bit-equal on every rank."""
    key = f"scan_chunk/{method}"
    r0 = gloo4[0]
    assert _rel(r0[f"{key}/loss"], r0[f"{key}/loss_unsharded"]) <= 1e-5
    assert np.array_equal(r0[f"{key}/nfe"], r0[f"{key}/nfe_unsharded"])
    assert len(r0[f"{key}/nfe"]) == 2
    if method.endswith("_adjoint"):
        back = r0[f"{key}/backward_nfe"]
        assert back.shape == (2, 4) and (back > 0).all()
        assert np.array_equal(back, r0[f"{key}/backward_nfe_unsharded"])
    for r in gloo4[1:]:
        assert np.array_equal(r[f"{key}/params"], r0[f"{key}/params"])
        assert r[f"{key}/loss"] == r0[f"{key}/loss"]
        assert np.array_equal(r[f"{key}/nfe"], r0[f"{key}/nfe"])


# ------------------------------------------------ the solvers' groups
def test_tree_math_holds_no_group_and_the_solvers_import_no_parallel():
    """The node group is the solve's option: ``ode.tree_math`` keeps no
    group at module scope, and importing the solvers (and the adjoint)
    loads nothing of ``ndcn_tpu_torch.parallel``."""
    import ast
    import inspect
    import subprocess
    import sys

    from ndcn_tpu_torch.ode import tree_math

    tree = ast.parse(inspect.getsource(tree_math))
    assigned = [t.id for node in tree.body if isinstance(node, ast.Assign)
                for t in node.targets]
    assert assigned == ["State"]
    assert not any(isinstance(node, ast.Global) for node in ast.walk(tree))
    modules = [node.module for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom)]
    assert not any("parallel" in m for m in modules), modules
    code = ("import sys, ndcn_tpu_torch.ode, ndcn_tpu_torch.ode.vcabm; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('ndcn_tpu_torch.parallel')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, check=True).stdout
    assert out.strip() == "[]", out


def test_replicated_leaf_norm_takes_no_collective(monkeypatch):
    """A node-sharded leaf's error ratio and initial-step norms take one
    sum-and-count over the group; a replicated leaf's (the adjoint's adj_t
    and parameter cotangents) take none and equal the unsharded ones."""
    from ndcn_tpu_torch.ode import grad_guard, step_control, tree_math
    from ndcn_tpu_torch.ode.api import odeint_with_stats

    calls = []

    def local(s, count, group):
        # a group of one: the local sum and count
        calls.append(group)
        return s.to(torch.float64), torch.tensor(float(count),
                                                 dtype=torch.float64)

    monkeypatch.setattr(tree_math, "sharded_sum_and_count", local)
    monkeypatch.setattr(grad_guard, "all_true", lambda flag, grp: flag)
    group = object()
    g = torch.Generator().manual_seed(0)
    y0 = (torch.rand(6, 2, generator=g), torch.rand(3, generator=g))
    y1 = tuple(y + 0.01 for y in y0)
    err = tuple(0.001 * torch.ones_like(y) for y in y0)
    groups = tree_math.leaf_groups(group, (True, False), 2)
    assert groups == (group, None)
    ratios = step_control.error_ratios(err, y0, y1, 0.01, 0.001,
                                       groups=groups)
    assert calls == [group]
    assert all(torch.equal(a, b) for a, b in zip(
        ratios, step_control.error_ratios(err, y0, y1, 0.01, 0.001)))
    calls.clear()
    step_control.select_initial_step(lambda t, y: y, torch.tensor(0.0), y0,
                                     4, 0.01, 0.001, y0, groups=groups)
    assert calls == [group] * 3
    # through the solve's options: the marks choose the leaves
    calls.clear()
    sol, stats = odeint_with_stats(
        lambda t, y: tuple(-v for v in y), y0, torch.tensor([0.0, 0.5]),
        rtol=0.01, atol=0.001, method="dopri5",
        options={"node_group": group, "node_sharded": (False, False)})
    assert calls == [] and stats.success
    sol_s, stats_s = odeint_with_stats(
        lambda t, y: tuple(-v for v in y), y0, torch.tensor([0.0, 0.5]),
        rtol=0.01, atol=0.001, method="dopri5",
        options={"node_group": group, "node_sharded": (True, False),
                 "differentiable": False})
    assert calls and set(map(id, calls)) == {id(group)}
    assert stats_s.nfe == stats.nfe


# ------------------------------------------------------------- drivers
def test_large_graph_mesh_one_rank():
    """--mesh on a world of one: the sharded program on a one-rank gloo
    group, its first-step parity, and the losses of the run without it."""
    import torch.distributed as dist

    from ndcn_tpu_torch.experiments import large_graph

    argv = ["--n", "2000", "--iters", "2", "--platform", "cpu"]
    sharded = large_graph.main(argv + ["--mesh"])
    plain = large_graph.main(argv)
    assert not dist.is_initialized()
    assert sharded["mesh_devices"] == 1 and sharded["mesh_backend"] == "gloo"
    assert sharded["mesh_parity"] < 1e-4
    assert plain["mesh_devices"] == 1 and plain["mesh_parity"] is None
    assert sharded["train_losses"] == plain["train_losses"]


@pytest.mark.parametrize("driver", ["heat", "dgnn"])
def test_driver_mesh_world_of_one_runs_unsharded(driver, capsys):
    if driver == "heat":
        from ndcn_tpu_torch.experiments.dynamics import main as run

        def main(argv):
            return run("heat", "heat", argv)

        argv = ["--niters", "4", "--test_freq", "2", "--platform", "cpu",
                "--method", "dopri5", "--sparse", "--sparse_format", "coo"]
    else:
        from ndcn_tpu_torch.experiments.dgnn import main

        argv = ["--dataset", "cora", "--model", "differential_gcn",
                "--epochs", "2", "--platform", "cpu", "--sparse"]
    sharded = main(argv + ["--mesh"])
    assert "--mesh: single device visible; running unsharded" in \
        capsys.readouterr().out
    assert sharded["train_losses"] == main(argv)["train_losses"]


def _two_ranks(module, argv, tmp_path, timeout=150):
    """Run ``python -m module argv`` as 2 gloo ranks (torchrun's
    environment on a localhost store); returns each rank's stdout."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1", PYTHONPATH=root)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    return outs


def _pairs(text, pattern):
    import re

    return [tuple(float(v) for v in m) for m in re.findall(pattern, text)]


def _losses(text, pattern):
    import re

    return [float(v) for v in re.findall(pattern, text)]


@pytest.mark.parametrize("driver", ["heat", "dgnn", "heat_replicas",
                                    "heat_replicas_adjoint", "heat_adjoint",
                                    "heat_lstm_gnn", "dgnn_GCN",
                                    "dgnn_batch_DeepGCN2", "heat_scan_chunk"])
def test_driver_mesh_two_gloo_ranks_match_unsharded(driver, tmp_path,
                                                    capsys):
    """--mesh on two ranks: the operator's rows, the node-major data and
    the losses split over the ranks (K1 on each rank's row block), with
    dropout drawn whole: every rank prints the unsharded run's losses
    (within 1e-5, beside the printed digits), and the dump is written.
    With ``--replicas 2`` the two ranks are the data axis, a replica each,
    and every rank prints the sweep's line over both; with ``--adjoint``
    too, each rank's replica trains on the batched adjoint (a model axis
    of one). ``--adjoint`` alone runs the continuous adjoint on a model
    axis of two, ``--baseline lstm_gnn`` the temporal baseline on the
    ranks' rows, and the GCN zoo (GCN, and DeepGCN2 under
    ``--batch_iters``) the rows of each rank. ``--scan_chunk 2`` trains
    each rank's row block in chunks (the bounded solve's norms and the
    gradients' sum over the model axis inside the step) against the
    unsharded chunked run, the final evaluation's NFE equal."""
    if driver.startswith("heat_replicas"):
        from ndcn_tpu_torch.experiments.dynamics import main as run

        # two steps: a replica alone and in a batch of two round apart
        # in the last bits, which Adam's later steps grow
        argv = ["--niters", "2", "--test_freq", "2", "--platform", "cpu",
                "--method", "dopri5", "--sparse", "--sparse_format", "coo",
                "--dropout", "0.1", "--replicas", "2"]
        if driver.endswith("adjoint"):
            argv.append("--adjoint")
        capsys.readouterr()
        run("heat", "heat", argv)
        pattern = r"(?:train|test) rel ([0-9.]+)±([0-9.]+)"
        ref = np.array(_pairs(capsys.readouterr().out, pattern))
        outs = _two_ranks("ndcn_tpu_torch.experiments.heat",
                          argv + ["--mesh"], tmp_path)
        for out in outs:
            assert "mesh: {'data': 2, 'model': 1}" in out
            got = np.array(_pairs(out, pattern))
            assert got.shape == ref.shape == (2, 2)
            assert np.allclose(got, ref, rtol=1e-5, atol=5e-7), (got, ref)
        return
    if driver.startswith("heat"):
        from ndcn_tpu_torch.experiments.dynamics import main as run

        argv = ["--niters", "4", "--test_freq", "2", "--platform", "cpu",
                "--method", "dopri5", "--sparse", "--sparse_format", "coo",
                "--dropout", "0.1", "--dump", "--results_dir",
                str(tmp_path / "res")]
        argv += {"heat": [], "heat_adjoint": ["--adjoint"],
                 "heat_lstm_gnn": ["--baseline", "lstm_gnn"],
                 "heat_scan_chunk": ["--scan_chunk", "2"]}[driver]
        if driver in ("heat_adjoint", "heat_lstm_gnn"):
            # two steps of the new paths: one report
            argv[1] = "2"
        from ndcn_tpu_torch.report.results import load_results

        ref_out = run("heat", "heat", argv)
        ref = ref_out["train_losses"]
        # the dump's evaluations' NFE (rank 0 writes the same path after)
        ref_nfe = load_results(ref_out["results_path"])["nfe_train"]
        outs = _two_ranks("ndcn_tpu_torch.experiments.heat",
                          argv + ["--mesh"], tmp_path)
        pattern, printed = r"Train Loss ([0-9.]+)\(", 1e-6   # {:.6f}
        assert os.listdir(tmp_path / "res")
        if driver == "heat_scan_chunk":
            assert load_results(ref_out["results_path"])["nfe_train"] == \
                ref_nfe
            for out in outs:
                assert "[scan_chunk] 2 chunks, 4 steps, 2 host reads" in out
    else:
        from ndcn_tpu_torch.experiments.dgnn import main as run

        argv = ["--dataset", "cora", "--epochs", "2", "--platform", "cpu",
                "--sparse", "--dropout", "0.2", "--data_dir",
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), "data")]
        argv += {"dgnn": ["--model", "differential_gcn"],
                 "dgnn_GCN": ["--model", "GCN"],
                 "dgnn_batch_DeepGCN2": ["--model", "DeepGCN2",
                                         "--batch_iters", "--iter", "1"],
                 }[driver]
        if driver != "dgnn":
            argv[3] = "1"       # one epoch of the new paths
        ref = run(argv)["train_losses"]
        outs = _two_ranks("ndcn_tpu_torch.experiments.dgnn",
                          argv + ["--mesh"], tmp_path)
        pattern, printed = (r"(?:loss_train:|mean train loss) ([0-9.]+)",
                            1e-4)                              # {:.4f}
    for out in outs:
        assert "mesh: {'data': 1, 'model': 2}" in out
        got = _losses(out, pattern)
        assert len(got) == len(ref)
        # 1e-5 relative, beside the printed digits' rounding
        assert np.allclose(got, ref, rtol=1e-5, atol=printed / 2), (got, ref)


def test_microbench_sharded_spmv_needs_the_card():
    from ndcn_tpu_torch.tools import microbench_sharded_spmv

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_sharded_spmv.main(["1000"])


def test_profile_model_axis_step_needs_the_card():
    from ndcn_tpu_torch.tools import profile_model_axis_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_model_axis_step.main(["1000"])


@pytest.mark.parametrize("cards,argv", [(1, ["4"]),
                                        (0, ["2", "--device", "cuda"]),
                                        (0, ["2"])])
def test_dryrun_refuses_fewer_cards_than_ranks(cards, argv, monkeypatch,
                                               capsys):
    """Unless ``--device cpu`` is asked, the ranks are NCCL ranks, one card
    each: fewer cards than ranks (none at all included) is an error that
    names ``--device cpu``, never a quiet switch to gloo."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dryrun, "spawn",
                        lambda *a, **k: pytest.fail("the ranks were started"))
    assert dryrun.main(argv) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_select_device_takes_the_local_rank_card(monkeypatch):
    """The drivers' device: torchrun's ``LOCAL_RANK``-th card, the first
    for a plain ``python``, the CPU only when asked."""
    from ndcn_tpu_torch.experiments.dynamics import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert select_device("gpu") == torch.device("cuda", 3)
    assert select_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert select_device("gpu") == torch.device("cuda", 0)
