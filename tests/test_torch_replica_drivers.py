"""The replica sweeps through the drivers on the CPU: the heat driver's
``--replicas``, the dgnn driver's ``--batch_iters`` / ``--budget_buckets``
and the T × alpha sweep's multi-replica cells, against the JAX package.

- one ``--batch_iters --iter 3`` epoch of differential_gcn (dense) and of
  DeepGCN2 (``--sparse``, K1) on cora at hidden 8, dropout 0, from the
  weights of ``jax.vmap`` of the JAX inits: each replica's test loss within
  1e-4 relative of the JAX batched step's (``jax.vmap(sgd_step)``, then the
  deterministic forward);
- a replica that runs out of budget is named by the JAX driver's
  ``[budget] replicas [...]`` line and the others' rows are bit-equal to
  their runs alone;
- ``--budget_buckets`` prints the JAX driver's bucket line for the same
  probed budgets;
- ``--replicas R --dump`` writes R results files, which both packages'
  summaries aggregate alike; the JAX driver's refusals;
- a T × alpha cell of ``--batch_iters --iter 2`` records the replicas' mean
  accuracy and standard deviation, and the CSV and cell log are the JAX
  sweep's for the same cell results.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndcn_tpu.data import load_planetoid as j_load_planetoid
from ndcn_tpu.experiments import dgnn as j_dgnn
from ndcn_tpu.experiments import sweep_t_alpha as j_sweep
from ndcn_tpu.graph.sparse import as_operator as j_as_operator
from ndcn_tpu.models import gcn_zoo as j_zoo
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
from ndcn_tpu.report import results as j_results
from ndcn_tpu.train import budget as j_budget
from ndcn_tpu.train.losses import cross_entropy as j_cross_entropy
from ndcn_tpu.train.optim import make_sgd_step as j_make_sgd_step
from ndcn_tpu.train.optim import torch_adam as j_torch_adam
from ndcn_tpu_torch.convert import params_from_jax, zoo_params_from_jax
from ndcn_tpu_torch.experiments import dgnn, sweep_t_alpha
from ndcn_tpu_torch.experiments.dynamics import build_parser, run
from ndcn_tpu_torch.parallel import sweep
from ndcn_tpu_torch.report import results
from ndcn_tpu_torch.train import budget

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one thread beats a pool that shares the
    cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    sys.path.insert(0, ROOT)
    from tools.make_synthetic_planetoid import make_dataset

    d = str(tmp_path_factory.mktemp("replicas"))
    make_dataset("replica_torch", n=300, n_features=64, n_classes=5,
                 out_dir=d, seed=0, n_test=60)
    return d


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("model_name,extra", [
    ("differential_gcn", []), ("DeepGCN2", ["--sparse"])])
def test_batch_iters_epoch_matches_the_jax_batched_step(monkeypatch,
                                                        model_name, extra):
    r, hidden, ms = 3, 8, 16
    data = j_load_planetoid("cora", alpha=0.5,
                            data_dir=os.path.join(ROOT, "data"))
    n, in_dim = data.features.shape
    classes = int(data.labels.max()) + 1
    keys = jax.random.split(jax.random.PRNGKey(0), r)
    j_op = j_as_operator(data.operator, sparse=bool(extra), format="coo")
    feats = jnp.asarray(data.features)
    labels = jnp.asarray(data.labels)
    idx_train, idx_test = (jnp.asarray(np.minimum(i, n - 1))
                           for i in (data.idx_train, data.idx_test))
    if model_name == "differential_gcn":
        params = jax.vmap(lambda k: j_init_ndcn(
            k, in_dim, hidden, classes, encoder_layers=1))(keys)
        vt = jnp.asarray(np.linspace(0, 2.0, 5), jnp.float32)

        def apply(p):
            out, stats = j_ndcn_forward(p, j_op, vt, feats, rtol=0.1,
                                        atol=0.1, terminal=True,
                                        max_steps=ms)
            return jnp.where(stats.success, out, jnp.nan)
    else:
        params = jax.vmap(lambda k: j_zoo.init_deep_gcn2(
            k, in_dim, hidden, classes))(keys)

        def apply(p):
            return j_zoo.deep_gcn2_apply(p, j_op, feats)

    def objective(p, rng):
        loss = j_cross_entropy(apply(p)[idx_train], labels[idx_train])
        return loss, loss

    opt = j_torch_adam(0.01, 5e-4)
    p1, _, _, _ = jax.vmap(j_make_sgd_step(opt, objective))(
        params, jax.vmap(opt.init)(params), keys)
    want = [float(j_cross_entropy(apply(jax.tree_util.tree_map(
        lambda a: a[i], p1))[idx_test], labels[idx_test])) for i in range(r)]

    def load(init_one, generators, device=None):
        tree = _to_np(params)
        if model_name == "differential_gcn":
            return params_from_jax(tree)
        return zoo_params_from_jax(model_name, tree)

    monkeypatch.setattr(sweep, "batched_init", load)
    out = dgnn.main(["--dataset", "cora", "--model", model_name,
                     "--hidden", str(hidden), "--dropout", "0", "--epochs",
                     "1", "--batch_iters", "--iter", str(r), "--max_steps",
                     str(ms), "--platform", "cpu", *extra])
    got = [row[1] for row in out["rows"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _dgnn(synth_dir, *argv):
    return dgnn.main(["--dataset", "replica_torch", "--data_dir", synth_dir,
                      "--platform", "cpu", "--hidden", "8", "--dropout",
                      "0", *argv])


def test_starved_replica_is_named_and_the_others_are_unchanged(synth_dir,
                                                               capsys):
    """At T 20 and rtol 1e-3 the inits of seeds 0-3 take 7, 8, 8 and 10
    attempts; a budget of 9 starves replica 3. The driver names every
    replica whose logits read NaN in the JAX driver's line, and each other
    replica's row is bit-equal to that replica trained alone."""
    stiff = ["--model", "differential_gcn", "--T", "20", "--rtol", "1e-3",
             "--atol", "1e-3", "--epochs", "1", "--batch_iters",
             "--max_steps", "9"]
    out = _dgnn(synth_dir, *stiff, "--seed", "0", "--iter", "4")
    printed = capsys.readouterr().out
    assert 3 in out["dead"] and len(out["dead"]) < 4
    assert (f"[budget] replicas {out['dead']} exhausted their step budget "
            f"during training" in printed)
    assert "--max_steps 9 was given explicitly" in printed
    for i in range(4):
        if i in out["dead"]:
            assert np.isnan(out["rows"][i][1])
            continue
        alone = _dgnn(synth_dir, *stiff, "--seed", str(i), "--iter", "1")
        assert alone["rows"][0][1:] == out["rows"][i][1:]


def test_budget_buckets_print_the_jax_drivers_line(synth_dir, capsys,
                                                   monkeypatch):
    """With the same probed budgets, the bucket line is the JAX driver's;
    each bucket trains at its own budget and every replica gets a row."""
    budgets = [16, 24, 16, 40, 24]
    monkeypatch.setattr(budget, "probe_step_budget_each",
                        lambda solves: [budgets[i] for i in
                                        range(len(solves))])
    out = _dgnn(synth_dir, "--model", "odeGCN", "--epochs", "2",
                "--batch_iters", "--iter", "5", "--budget_buckets", "2")
    groups = j_budget.bucket_budgets(budgets, 2)
    line = "budget buckets: " + ", ".join(
        f"{len(ix)} replica(s) @ max_steps {b}" for b, ix in groups)
    printed = capsys.readouterr().out
    assert line in printed.splitlines()
    assert re.search(r"\[bucket 1: ms 40\]", printed)
    assert out["buckets"] == [(int(b), ix.tolist()) for b, ix in groups]
    assert len(out["rows"]) == 5 and np.isfinite(out["acc_mean"])


@pytest.mark.parametrize("model_name,extra", [
    ("GCN", ["-nhl", "1", "--sparse", "--sparse_format", "bsr"]),
    ("DeepGCN", ["-nhl", "1", "--sparse", "--sparse_format", "ell"]),
    ("DeepGCN4", ["-nhl", "2", "--sparse"])])
def test_batch_iters_zoo_replicas_are_their_runs_alone(synth_dir, model_name,
                                                       extra):
    """Each zoo replica (dropout 0.5: each replica's masks from its own
    generator) ends where its run alone at seed ``--seed`` + i ends."""
    argv = ["--model", model_name, "--epochs", "3", "--dropout", "0.5",
            "--batch_iters", *extra]
    out = _dgnn(synth_dir, *argv, "--seed", "4", "--iter", "2")
    for i in range(2):
        alone = _dgnn(synth_dir, *argv, "--seed", str(4 + i), "--iter", "1")
        np.testing.assert_allclose(alone["rows"][0][1:3],
                                   out["rows"][i][1:3], rtol=1e-5)


def test_heat_replicas_dump_summarize_and_refusals(tmp_path, capsys):
    """``--replicas 3 --dump``: the JAX driver's log line and return, one
    results file per replica that both packages' summaries read alike; the
    JAX driver's refusals; ``--adjoint`` and the Adams methods, refused
    until ROADMAP §1 entry 11a′ was ported, run."""
    base = ["--n", "36", "--time_tick", "8", "--platform", "cpu"]
    out = run("heat", build_parser("t").parse_args(
        base + ["--method", "dopri5", "--niters", "2", "--test_freq", "2",
                "--replicas", "3", "--dump", "--results_dir",
                str(tmp_path)]))
    printed = capsys.readouterr().out
    assert re.search(r"Iter 0002\| 3 replicas \| train rel [0-9.]+±[0-9.]+ "
                     r"\| test rel [0-9.]+±[0-9.]+ \| Time", printed)
    assert f"Dumped 3 replica results under {tmp_path}" in printed
    assert out["replicas"] == 3 and set(out["final"]) == {
        "abs_error", "rel_error", "rel_error_std", "abs_error2",
        "rel_error2"}
    names = sorted(os.listdir(tmp_path))
    assert names == [f"result_replica{i:03d}.ndcn" for i in range(3)]
    mine = results.summarize_directory(str(tmp_path), "ndcn")
    theirs = j_results.summarize_directory(str(tmp_path), "ndcn")
    assert mine == theirs and mine["n_runs"] == 3
    assert np.isclose(out["final"]["abs_error"], mine["abs_error_mean"])
    assert np.isclose(out["final"]["rel_error_std"], mine["rel_error_std"])
    for extra, err, match in (
            (["--baseline", "lstm_gnn"], SystemExit, "continuous"),
            (["--ckpt_dir", str(tmp_path)], SystemExit, "incompatible")):
        with pytest.raises(err, match=match):
            run("heat", build_parser("t").parse_args(
                base + ["--replicas", "2", *extra]))
    for extra in (["--method", "dopri5", "--adjoint"],
                  ["--method", "adams", "--adjoint"]):
        res = run("heat", build_parser("t").parse_args(
            base + ["--replicas", "2", "--niters", "2", "--test_freq", "2",
                    *extra]))
        assert res["replicas"] == 2 and np.isfinite(
            res["final"]["rel_error"])
        # the adams budget is the JAX driver's default, not a probe
        assert (res["max_steps"] == 256) == ("adams" in extra)
    # --mesh is no refusal: a world of one runs the sweep unsharded, as the
    # JAX driver does on one device
    capsys.readouterr()
    meshed = run("heat", build_parser("t").parse_args(
        base + ["--method", "dopri5", "--niters", "2", "--test_freq", "2",
                "--replicas", "3", "--mesh"]))
    assert "--mesh: single device visible; running unsharded" in \
        capsys.readouterr().out
    assert meshed["final"] == out["final"]


def test_sweep_cell_of_two_replicas(synth_dir, tmp_path, monkeypatch):
    """A cell of ``--batch_iters --iter 2`` trains both replicas at once and
    records their mean accuracy and its standard deviation; given the same
    cell results, the CSV and the cell log are the JAX sweep's."""
    grid = ["--T_values", "1.2", "--alpha_values", "0.0", "1.0",
            "--dataset", "replica_torch", "--data_dir", synth_dir,
            "--epochs", "2", "--hidden", "8", "--time_tick", "4",
            "--method", "euler", "--platform", "cpu", "--batch_iters",
            "--iter", "2"]
    out_csv = str(tmp_path / "port.csv")
    cells = []
    real_run = dgnn.run

    def recording(args):
        cells.append(real_run(args))
        return cells[-1]

    monkeypatch.setattr(dgnn, "run", recording)
    grid_port = sweep_t_alpha.main(grid + ["--out_csv", out_csv])
    assert len(cells) == 2
    for j, cell in enumerate(cells):
        accs = [row[2] for row in cell["rows"]]
        assert len(accs) == 2
        assert grid_port[0, j] == pytest.approx(np.mean(accs))
        assert cell["acc_std"] == pytest.approx(np.std(accs, ddof=1))
    # the JAX sweep over the same cells, its dgnn ``run`` answering with the
    # port's cell results
    it = iter(cells)
    monkeypatch.setattr(j_dgnn, "run", lambda args: next(it))
    j_csv = str(tmp_path / "jax.csv")
    j_sweep.main(grid + ["--out_csv", j_csv])
    for suffix in ("", ".cells"):
        with open(out_csv + suffix) as a, open(j_csv + suffix) as b:
            assert a.read() == b.read()
