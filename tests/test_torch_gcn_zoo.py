"""The port's GCN zoo against the JAX package's, at weights carried across
with ``convert.zoo_params_from_jax``, deterministic: on dense, COO (K1's
plain version), ELL and BSR (K3's plain version) operators of a synthetic
Planetoid graph (300 nodes, 64 features, 5 classes), the logits within
1e-5 of JAX's as max|Δ| / max|y| and every parameter's gradient of the
cross-entropy within 1e-4 rel-L1 of ``jax.grad`` (the JAX side on its own
operator of the same format: BSR through its Pallas kernel in interpret
mode). DeepGCN3 on the dense operator only, as the JAX docstring says.
Also DeepGCN2 on cora's COO operator at the raw width d = 1433, and K1's
plain version against JAX's Pallas ``tiled_spmv`` in interpret mode at the
classes' and hidden widths."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.data import load_planetoid as j_load_planetoid
from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.graph.sparse import from_scipy_coo as j_from_scipy_coo
from ndcn_tpu.kernels.coo_spmv import tiled_spmv
from ndcn_tpu.models import gcn_zoo as jz
from ndcn_tpu.train.losses import cross_entropy as j_cross_entropy
from ndcn_tpu_torch.convert import zoo_params_from_jax, zoo_params_to_jax
from ndcn_tpu_torch.data import load_planetoid
from ndcn_tpu_torch.graph.sparse import as_operator, from_scipy_coo
from ndcn_tpu_torch.kernels import coo_spmv
from ndcn_tpu_torch.models import gcn_zoo
from ndcn_tpu_torch.train.losses import cross_entropy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, NHL = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small products: one thread beats a pool that shares the cores
    with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    sys.path.insert(0, ROOT)
    from tools.make_synthetic_planetoid import make_dataset

    d = str(tmp_path_factory.mktemp("zoo"))
    make_dataset("zoo_torch", n=300, n_features=64, n_classes=5, out_dir=d,
                 seed=0, n_test=60)
    return load_planetoid("zoo_torch", alpha=0.5, data_dir=d)


# name -> (JAX init(key, in, hidden, classes, n), JAX apply(p, op, x),
#          port model kwargs)
CASES = {
    "GCN": (lambda k, i, h, c, n: jz.init_gcn(k, i, h, c, NHL),
            lambda p, op, x: jz.gcn_apply(p, op, x), {}),
    "DeepGCN": (lambda k, i, h, c, n: jz.init_deep_gcn(k, i, h, c, NHL),
                lambda p, op, x: jz.deep_gcn_apply(p, op, x), {}),
    "DeepGCN2": (lambda k, i, h, c, n: jz.init_deep_gcn2(k, i, h, c),
                 lambda p, op, x: jz.deep_gcn2_apply(p, op, x), {}),
    "DeepGCN3": (lambda k, i, h, c, n: jz.init_deep_gcn3(k, i, h, c, n),
                 lambda p, op, x: jz.deep_gcn3_apply(p, op, x, NHL), {}),
    "DeepGCN4": (lambda k, i, h, c, n: jz.init_deep_gcn4(k, i, h, c, NHL),
                 lambda p, op, x: jz.deep_gcn4_apply(p, op, x), {}),
    "resGCN": (lambda k, i, h, c, n: jz.init_res_gcn(k, i, h, c, NHL,
                                                      euler=True),
               lambda p, op, x: jz.res_gcn_apply(p, op, x), {}),
    "resGCN_normalize_time_varying": (
        lambda k, i, h, c, n: jz.init_res_gcn(k, i, h, c, NHL, euler=True,
                                              time_varying=True),
        lambda p, op, x: jz.res_gcn_apply(p, op, x, normalize=True),
        dict(normalize=True)),
}


def _port_model(name, tree, n, **kw):
    """The port's model shaped for ``tree``, with the weights carried."""
    base = name.split("_")[0]
    g = torch.Generator().manual_seed(1)
    i, c = 64, 5
    if base == "DeepGCN3":
        model = gcn_zoo.DeepGCN3(i, HIDDEN, c, n, NHL, generator=g)
    elif base == "resGCN":
        model = gcn_zoo.ResGCN(i, HIDDEN, c, NHL, euler=True,
                               time_varying="linear" in tree["blocks"][0],
                               generator=g, **kw)
    else:
        model = gcn_zoo.build_zoo_model(base, i, HIDDEN, c, n, NHL,
                                        generator=g)
    return zoo_params_from_jax(base, tree, model)


def _grad_tree(ref):
    """The port's gradients in the JAX tree's layout (numpy)."""
    if isinstance(ref, torch.nn.Linear):
        out = {"w": ref.weight.grad.numpy().T}
        if ref.bias is not None:
            out["b"] = ref.bias.grad.numpy()
        return out
    if isinstance(ref, gcn_zoo.DiagLinear):
        return {"weight": _grad_tree(ref.weight)}
    if isinstance(ref, torch.Tensor):
        # a parameter the forward does not use (DeepGCN2's time_step, the
        # DiagLinear weights) has no gradient here and a zero one in JAX
        return (np.zeros(tuple(ref.shape), np.float32) if ref.grad is None
                else ref.grad.numpy())
    if isinstance(ref, dict):
        return {k: _grad_tree(v) for k, v in ref.items()}
    return [_grad_tree(v) for v in ref]


def _compare_grads(got, ref):
    flat_g = jax.tree_util.tree_leaves(got)
    flat_r = jax.tree_util.tree_leaves(ref)
    assert len(flat_g) == len(flat_r)
    for g, r in zip(flat_g, flat_r):
        r = np.asarray(r)
        assert g.shape == r.shape
        denom = np.abs(r).sum()
        if denom == 0.0:
            assert np.abs(g).max() == 0.0
        else:
            assert np.abs(g - r).sum() / denom <= 1e-4


FORMATS = {"dense": dict(sparse=False), "coo": dict(sparse=True, format="coo"),
           "ell": dict(sparse=True, format="ell"),
           "bsr": dict(sparse=True, format="bsr")}


# DeepGCN3 takes the dense operator (the JAX docstring)
@pytest.mark.parametrize("name,fmt", [
    (name, fmt) for name in CASES for fmt in FORMATS
    if name != "DeepGCN3" or fmt == "dense"])
def test_zoo_logits_and_grads_match_jax(synth, name, fmt):
    init, apply, kw = CASES[name]
    n, i = synth.features.shape
    tree = init(jax.random.PRNGKey(3), i, HIDDEN, 5, n)
    j_op = j_as_operator(synth.operator, **FORMATS[fmt])
    x_j = jnp.asarray(synth.features)
    idx = synth.idx_train
    lab = jnp.asarray(synth.labels[idx])

    def j_loss(p):
        logits = apply(p, j_op, x_j)
        return j_cross_entropy(logits[idx], lab), logits

    (_, ref), j_grads = jax.value_and_grad(j_loss, has_aux=True)(tree)
    ref = np.asarray(ref)

    model = _port_model(name, jax.tree_util.tree_map(np.asarray, tree), n,
                        **kw)
    op = as_operator(synth.operator, **FORMATS[fmt])
    logits = model(op, torch.as_tensor(synth.features))
    cross_entropy(logits[torch.as_tensor(idx).long()],
                  torch.as_tensor(synth.labels[idx])).backward()
    got = logits.detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    _compare_grads(_grad_tree(model.jax_tree()), j_grads)


@pytest.mark.parametrize("name", ["GCN", "DeepGCN4", "resGCN"])
def test_zoo_weights_round_trip_through_jax_tree(name):
    init, _, kw = CASES[name]
    tree = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), 64, HIDDEN, 5, 300))
    back = zoo_params_to_jax(zoo_params_from_jax(name, tree))
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    flat_t, def_t = jax.tree_util.tree_flatten(tree)
    assert def_b == def_t
    assert all(np.array_equal(a, b) for a, b in zip(flat_b, flat_t))


def test_zoo_rejects_a_tree_of_another_shape():
    tree = jax.tree_util.tree_map(
        np.asarray, jz.init_gcn(jax.random.PRNGKey(0), 64, HIDDEN, 5, 1))
    model = gcn_zoo.GCN(64, HIDDEN, 5, 2,
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="middle"):
        zoo_params_from_jax("GCN", tree, model)


def test_zoo_dropout_is_drawn_from_the_generator(synth):
    """Training mode drops with the given generator (one seed, one
    answer), and without a generator or deterministic drops nothing."""
    n, i = synth.features.shape
    op = as_operator(synth.operator, sparse=True, format="coo")
    x = torch.as_tensor(synth.features)
    model = gcn_zoo.GCN(i, HIDDEN, 5, 1, dropout=0.5,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(op, x, torch.Generator().manual_seed(5), False)
        b = model(op, x, torch.Generator().manual_seed(5), False)
        c = model(op, x, torch.Generator().manual_seed(6), False)
        det = model(op, x, torch.Generator().manual_seed(5), True)
        none = model(op, x, None, False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(det, none) and not torch.equal(a, det)


@pytest.fixture(scope="module")
def cora():
    data_dir = os.path.join(ROOT, "data")
    return (load_planetoid("cora", alpha=0.5, data_dir=data_dir),
            j_load_planetoid("cora", alpha=0.5, data_dir=data_dir))


def test_deep_gcn2_on_cora_coo_at_the_raw_width(cora):
    """A applied to cora's 1433 raw features (K1's plain version at the
    wide width) against JAX's COO matvec, and the model's logits."""
    data, j_data = cora
    tree = jz.init_deep_gcn2(jax.random.PRNGKey(0), 1433, HIDDEN, 7)
    j_op = j_as_operator(j_data.operator, sparse=True, format="coo")
    op = as_operator(data.operator, sparse=True, format="coo")
    x = torch.as_tensor(data.features)
    ax_ref = np.asarray(jax.jit(lambda v: __import__(
        "ndcn_tpu.graph.sparse", fromlist=["matvec"]).matvec(j_op, v))(
            jnp.asarray(j_data.features)))
    ax = coo_spmv.coo_spmv(op, x).numpy()
    assert ax.shape == (2708, 1433)
    assert np.abs(ax - ax_ref).max() <= 1e-5 * np.abs(ax_ref).max()
    ref = np.asarray(jz.deep_gcn2_apply(tree, j_op,
                                        jnp.asarray(j_data.features)))
    model = zoo_params_from_jax(
        "DeepGCN2", jax.tree_util.tree_map(np.asarray, tree))
    with torch.no_grad():
        got = model(op, x).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("d", [7, 16])
def test_k1_plain_matches_jax_tiled_kernel_interpret(synth, d):
    """K1's plain version against the JAX package's Pallas sliced-tile
    kernel in interpret mode (1e-4: that kernel's bf16-split numerics, the
    bar of ``test_torch_kernels.py``), at the classes' and hidden widths."""
    x = np.random.RandomState(d).randn(synth.operator.shape[0], d).astype(
        np.float32)
    j_op = j_from_scipy_coo(synth.operator, tiled=True)
    ref = np.asarray(tiled_spmv(j_op.tiles, j_op.tiles_t, jnp.asarray(x)))
    got = coo_spmv.coo_spmv(from_scipy_coo(synth.operator),
                            torch.as_tensor(x)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
