"""The classification slice of the port against the JAX package: the NDCN
classifiers (``differential_gcn``, ``odeGCN``) at carried weights, the
losses, three Adam steps, and the driver ``experiments.dgnn`` with its legacy
fronts on the CPU.

Bars (ROADMAP's parity bounds): terminal logits within 1e-4 rel-L1 of
JAX's, every gradient within 1e-3, equal NFE, on dense, COO and BSR
operators of a synthetic Planetoid graph (300 nodes, 64 features, 5
classes; JAX on its own operator of the same format), dropout 0, at the
driver's rtol = atol = 0.1 and at 1e-3; the losses within 1e-6; three Adam
steps within 1e-4 rel-L1 of JAX's ``make_sgd_step(torch_adam(...))``."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.graph.generators import girvan_newman_labels as j_gn_labels
from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import gcn_zoo as jz
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.train import losses as j_losses
from ndcn_tpu.train.optim import make_sgd_step as j_make_sgd_step
from ndcn_tpu.train.optim import torch_adam as j_torch_adam
from ndcn_tpu_torch.convert import (params_from_jax, params_to_jax,
                                    zoo_params_from_jax, zoo_params_to_jax)
from ndcn_tpu_torch.data import load_planetoid
from ndcn_tpu_torch.experiments import dgnn, train_gcn, train_resgcn
from ndcn_tpu_torch.graph.generators import girvan_newman_labels
from ndcn_tpu_torch.graph.sparse import as_operator
from ndcn_tpu_torch.models import ndcn_forward
from ndcn_tpu_torch.train import budget, losses
from ndcn_tpu_torch.train.checkpoint import all_checkpoint_steps
from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(ROOT, "data")
HIDDEN = 16
FORMATS = {"dense": dict(sparse=False), "coo": dict(sparse=True, format="coo"),
           "bsr": dict(sparse=True, format="bsr")}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Thousands of small solver operations: one thread beats a pool that
    shares the cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    sys.path.insert(0, ROOT)
    from tools.make_synthetic_planetoid import make_dataset

    d = str(tmp_path_factory.mktemp("dgnn"))
    make_dataset("dgnn_torch", n=300, n_features=64, n_classes=5, out_dir=d,
                 seed=0, n_test=60)
    return d


@pytest.fixture(scope="module")
def synth(synth_dir):
    return load_planetoid("dgnn_torch", alpha=0.5, data_dir=synth_dir)


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


# model -> (encoder layers, no_control, time grid)
ODE_MODELS = {
    "differential_gcn": (1, False, np.linspace(0, 1.2, 4).astype(np.float32)),
    "odeGCN": (2, True, np.linspace(0, 1.9, 10).astype(np.float32)),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("tol", [0.1, 1e-3])
@pytest.mark.parametrize("name", list(ODE_MODELS))
def test_ode_classifiers_match_jax(synth, name, tol, fmt):
    enc, no_control, vt = ODE_MODELS[name]
    n, i = synth.features.shape
    tree = j_init_ndcn(jax.random.PRNGKey(4), i, HIDDEN, 5,
                       no_control=no_control, encoder_layers=enc)
    kw = dict(rtol=tol, atol=tol, method="dopri5", terminal=True,
              no_control=no_control, max_steps=64)
    idx = synth.idx_train
    lab = jnp.asarray(synth.labels[idx])
    j_op = j_as_operator(synth.operator, **FORMATS[fmt])

    def j_loss(p):
        out, stats = j_ndcn_forward(p, j_op, jnp.asarray(vt),
                                    jnp.asarray(synth.features), **kw)
        return j_losses.cross_entropy(out[idx], lab), (out, stats)

    (_, (ref, j_stats)), j_grads = jax.value_and_grad(
        j_loss, has_aux=True)(tree)
    assert bool(j_stats.success)

    model = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    assert (model.enc2 is not None) == (enc == 2)
    assert (model.wt is None) == no_control
    op = as_operator(synth.operator, **FORMATS[fmt])
    out, stats = ndcn_forward(model, op, vt, torch.as_tensor(synth.features),
                              **kw)
    assert stats.success and stats.nfe == int(j_stats.nfe)
    losses.cross_entropy(out[torch.as_tensor(idx).long()],
                         torch.as_tensor(synth.labels[idx])).backward()
    assert rel_l1(out.detach().numpy(), ref) <= 1e-4
    for name_, layer in (("enc1", model.enc1), ("enc2", model.enc2),
                         ("wt", model.wt), ("dec", model.dec)):
        if layer is None:
            continue
        assert rel_l1(layer.weight.grad.numpy().T,
                      j_grads[name_]["w"]) <= 1e-3, name_
        assert rel_l1(layer.bias.grad.numpy(), j_grads[name_]["b"]) <= 1e-3


@pytest.mark.parametrize("enc,no_control", [(1, False), (2, True)])
def test_params_from_jax_round_trips_the_classifier_layer_sets(enc,
                                                               no_control):
    """differential_gcn (encoder_layers=1) and odeGCN (encoder_layers=2,
    no control) through the NDCN converter and back, unchanged."""
    tree = jax.tree_util.tree_map(np.asarray, j_init_ndcn(
        jax.random.PRNGKey(0), 64, HIDDEN, 5, no_control=no_control,
        encoder_layers=enc))
    back = params_to_jax(params_from_jax(tree))
    assert set(back) == set(tree)
    for layer in tree:
        assert set(back[layer]) == set(tree[layer])
        for leaf in tree[layer]:
            assert np.array_equal(back[layer][leaf], tree[layer][leaf])


def test_losses_match_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(200, 7).astype(np.float32) * 3
    labels = rs.randint(0, 7, 200).astype(np.int32)
    t_logits, t_labels = torch.as_tensor(logits), torch.as_tensor(labels)
    j_logits, j_labels = jnp.asarray(logits), jnp.asarray(labels)
    assert abs(float(losses.cross_entropy(t_logits, t_labels))
               - float(j_losses.cross_entropy(j_logits, j_labels))) <= 1e-6
    assert abs(float(losses.accuracy(t_logits, t_labels))
               - float(j_losses.accuracy(j_logits, j_labels))) <= 1e-6
    got = losses.f1_scores(t_logits, t_labels)
    ref = j_losses.f1_scores(j_logits, j_labels)
    assert all(abs(g - r) <= 1e-6 for g, r in zip(got, ref))


def _jax_adam_steps(tree, loss_fn, steps):
    opt = j_torch_adam(0.01, 5e-4)
    step = jax.jit(j_make_sgd_step(opt, loss_fn))
    state = opt.init(tree)
    for _ in range(steps):
        tree, state, _, _ = step(tree, state, None)
    return tree


def _torch_adam_steps(model, loss_fn, steps):
    step = make_sgd_step(torch_adam(model.parameters(), 0.01, 5e-4), loss_fn)
    for _ in range(steps):
        step()


def _close_trees(got, ref):
    flat_g, def_g = jax.tree_util.tree_flatten(got)
    flat_r, def_r = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(np.asarray, ref))
    assert def_g == def_r
    for g, r in zip(flat_g, flat_r):
        assert rel_l1(g, r) <= 1e-4


@pytest.mark.parametrize("name", ["GCN", "differential_gcn"])
def test_three_adam_steps_match_jax(synth, name):
    """The slice as a whole: three Adam steps (lr 0.01, weight decay 5e-4)
    at carried weights with dropout 0, the parameters within 1e-4."""
    n, i = synth.features.shape
    idx = synth.idx_train
    x_j, lab_j = jnp.asarray(synth.features), jnp.asarray(synth.labels[idx])
    x_t = torch.as_tensor(synth.features)
    idx_t = torch.as_tensor(idx).long()
    lab_t = torch.as_tensor(synth.labels[idx])
    j_op = j_as_operator(synth.operator, sparse=True, format="coo")
    op = as_operator(synth.operator, sparse=True, format="coo")
    vt = np.linspace(0, 1.2, 4).astype(np.float32)
    kw = dict(rtol=0.1, atol=0.1, method="dopri5", terminal=True,
              max_steps=32)
    if name == "GCN":
        tree = jz.init_gcn(jax.random.PRNGKey(5), i, HIDDEN, 5, 1)
        model = zoo_params_from_jax(
            "GCN", jax.tree_util.tree_map(np.asarray, tree))

        def j_fn(p, rng):
            logits = jz.gcn_apply(p, j_op, x_j)
            return j_losses.cross_entropy(logits[idx], lab_j), logits

        def t_fn():
            logits = model(op, x_t)
            return losses.cross_entropy(logits[idx_t], lab_t), logits

        to_jax = zoo_params_to_jax
    else:
        tree = j_init_ndcn(jax.random.PRNGKey(5), i, HIDDEN, 5,
                           encoder_layers=1)
        model = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))

        def j_fn(p, rng):
            out, _ = j_ndcn_forward(p, j_op, jnp.asarray(vt), x_j, **kw)
            return j_losses.cross_entropy(out[idx], lab_j), out

        def t_fn():
            out, _ = ndcn_forward(model, op, vt, x_t, **kw)
            return losses.cross_entropy(out[idx_t], lab_t), out

        to_jax = params_to_jax
    ref = _jax_adam_steps(tree, j_fn, 3)
    _torch_adam_steps(model, t_fn, 3)
    _close_trees(to_jax(model), ref)


# ------------------------------------------------------------------ driver


def _run(synth_dir, *argv, model="GCN"):
    args, _ = dgnn.build_parser().parse_known_args(
        ["--model", model, "--dataset", "dgnn_torch", "--data_dir", synth_dir,
         "--platform", "cpu", "--seed", "1", *argv])
    return dgnn.run(args)


@pytest.mark.parametrize("model,extra", [
    ("GCN", ["-nhl", "1"]), ("DeepGCN", ["-nhl", "2"]), ("DeepGCN2", []),
    ("DeepGCN3", ["-nhl", "1"]), ("DeepGCN4", ["-nhl", "2"]),
    ("resGCN", ["-nhl", "2", "--Euler", "--normalize"]),
    ("odeGCN", []), ("differential_gcn", ["--T", "1.2", "--time_tick", "4"]),
])
@pytest.mark.parametrize("fmt", ["dense", "coo", "ell", "bsr"])
def test_driver_trains_every_model_on_every_format(synth_dir, model, extra,
                                                   fmt):
    sparse = [] if fmt == "dense" else ["--sparse", "--sparse_format", fmt]
    out = _run(synth_dir, "--epochs", "8", "--lr", "0.02", "--dropout", "0",
               *extra, *sparse, model=model)
    assert np.isfinite(out["rows"][0][1])
    assert all(np.isfinite(out["train_losses"]))
    assert out["train_losses"][-1] < out["train_losses"][0]


def test_driver_gcn_on_cora_learns():
    """60 epochs of GCN on cora beat the JAX test's bar (0.55) on test
    accuracy (the COO operator: K1's plain version)."""
    args, _ = dgnn.build_parser().parse_known_args(
        ["--model", "GCN", "--epochs", "60", "--hidden", "16", "--seed", "1",
         "--data_dir", DATA_DIR, "--platform", "cpu", "--sparse"])
    out = dgnn.run(args)
    assert out["rows"][0][2] > 0.55


def test_driver_starved_budget_rolls_back_and_doubles(synth_dir, monkeypatch):
    monkeypatch.setattr(budget, "probe_step_budget", lambda probe, **kw: 2)
    out = _run(synth_dir, "--epochs", "12", "--T", "1.2", "--time_tick", "6",
               "--dropout", "0", "--rtol", "0.01", "--atol", "0.01",
               model="differential_gcn")
    assert out["elastic_retries"] >= 1 and out["max_steps"] > 2
    assert np.isfinite(out["rows"][0][1])
    assert len(out["train_losses"]) == 12


def test_driver_resumes_mid_iter_bit_equal(synth_dir, tmp_path):
    """--ckpt_dir: the run killed mid-ITER (the newer checkpoints pruned)
    and resumed lands on the uninterrupted run's rows exactly."""
    base = ["--iter", "2", "--epochs", "4", "--hidden", "8", "--T", "1.2",
            "--time_tick", "4", "--method", "euler", "--dropout", "0.5",
            "--seed", "7"]
    rows_ref = _run(synth_dir, *base, model="differential_gcn")["rows"]
    d = str(tmp_path / "ckpt")
    ck = [*base, "--ckpt_dir", d, "--ckpt_freq", "3"]
    rows_full = _run(synth_dir, *ck, model="differential_gcn")["rows"]
    assert sorted(all_checkpoint_steps(d)) == [4, 6, 8]
    os.unlink(os.path.join(d, "ckpt_00000008.pkl"))
    rows_resumed = _run(synth_dir, *ck, model="differential_gcn")["rows"]
    assert len(rows_ref) == len(rows_full) == len(rows_resumed) == 2
    for rr, rf, rn in zip(rows_resumed, rows_ref, rows_full):
        assert rr[1:] == rf[1:] == rn[1:]
    # a finished run resumes past the loop, the rows restored whole
    rows_again = _run(synth_dir, *ck, model="differential_gcn")["rows"]
    assert [r[1:] for r in rows_again] == [r[1:] for r in rows_full]


@pytest.mark.parametrize("flag,entry", [
    (["--batch_iters"], "entry 11"), (["--budget_buckets", "2"], "entry 11"),
    (["--mesh"], "entry 11"),
    (["--export", "x.bin", "--model", "differential_gcn"], "entry 11"),
    (["--precision", "high"], "entry 6")])
def test_driver_refuses_unported_flags_before_loading(flag, entry, tmp_path):
    args, _ = dgnn.build_parser().parse_known_args(
        ["--data_dir", str(tmp_path / "nothing_here"), "--platform", "cpu",
         *flag])
    with pytest.raises(NotImplementedError, match=entry):
        dgnn.run(args)


@pytest.mark.parametrize("flag", [
    ["--export", "x.bin"],                                  # GCN
    ["--export", "x.bin", "--model", "odeGCN", "--batch_iters"],
    ["--ckpt_dir", "c", "--batch_iters"]])
def test_driver_keeps_the_jax_argument_errors(flag, tmp_path):
    args, _ = dgnn.build_parser().parse_known_args(
        ["--data_dir", str(tmp_path), "--platform", "cpu", *flag])
    with pytest.raises(SystemExit):
        dgnn.run(args)


def test_driver_gpu_platform_needs_a_card(monkeypatch, synth_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args, _ = dgnn.build_parser().parse_known_args(
        ["--dataset", "dgnn_torch", "--data_dir", synth_dir])
    with pytest.raises(RuntimeError, match="CUDA"):
        dgnn.run(args)


@pytest.mark.parametrize("front,allowed,refused", [
    (train_gcn, ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4"),
     ("resGCN", "odeGCN", "differential_gcn")),
    (train_resgcn, ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4",
                    "resGCN", "odeGCN"), ("differential_gcn",))])
def test_legacy_fronts_restrict_models_and_map_delta(front, allowed, refused,
                                                     monkeypatch):
    assert front.LEGACY_MODELS == allowed
    seen = []
    monkeypatch.setattr(dgnn, "run", lambda args: seen.append(args) or {})
    for model in allowed:
        front.main(["--model", model, "--delta", "0.25", "--alpha", "0.9"])
    assert [a.alpha for a in seen] == [0.25] * len(allowed)
    for model in refused:
        with pytest.raises(SystemExit):
            front.main(["--model", model])


def test_legacy_front_runs_the_driver(synth_dir):
    out = train_resgcn.main(["--model", "resGCN", "-nhl", "1", "--Euler",
                             "--epochs", "3", "--dataset", "dgnn_torch",
                             "--data_dir", synth_dir, "--platform", "cpu",
                             "--delta", "0.0"])
    assert np.isfinite(out["rows"][0][1])


def test_girvan_newman_labels_equal_jax():
    rs = np.random.RandomState(0)
    a = (rs.rand(30, 30) < 0.15).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    for splits in (1, 3):
        assert np.array_equal(girvan_newman_labels(a, splits),
                              j_gn_labels(a, splits))
