"""The port's ``report`` package, ``utils.timing`` and the drivers'
``--dump`` / ``--viz`` / ``--profile_dir`` against the JAX package: one
results schema that both packages read (each loads the other's dumps and
summarizes their directories alike), the plots, the profiler trace's off
path and the notifier, and a profiled run whose losses are bit-equal to
the run without the profiler."""

import os

import jax
import numpy as np
import pytest
import torch

from ndcn_tpu.experiments import summarize as j_summarize
from ndcn_tpu.models import init_ndcn as j_init_ndcn
from ndcn_tpu.report import results as j_results
from ndcn_tpu_torch.convert import model_from_jax, params_from_jax
from ndcn_tpu_torch.experiments import summarize
from ndcn_tpu_torch.experiments.dynamics import build_parser, run
from ndcn_tpu_torch.models import init_ndcn, init_temporal_gcn
from ndcn_tpu_torch.report import notify, results, viz
from ndcn_tpu_torch.utils import timing

HEAT = ["--n", "25", "--time_tick", "8", "--niters", "6", "--test_freq", "2",
        "--platform", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Many small operations: one thread beats a pool that shares the
    cores with other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_run(mod, model_tree, seed):
    """One package's results dict of two evaluations, ``model_tree`` its
    weights (a port model, or a JAX tree)."""
    rs = np.random.RandomState(seed)
    res = mod.new_results_dict({"baseline": "ndcn", "seed": seed})
    res["true_y"].append(rs.rand(25, 12).astype(np.float32))
    for itr in (10, 20):
        mod.record_eval(res, itr, rs.rand(), rs.rand(),
                        rs.rand(25, 2).astype(np.float32), model_tree,
                        abs_error2=rs.rand(), rel_error2=rs.rand(),
                        predict_y2=rs.rand(25, 2).astype(np.float32))
    res["total_time"] = 1.5
    return res


def test_schema_keys_are_the_jax_packages():
    args = {"baseline": "ndcn", "n": 400}
    mine, theirs = results.new_results_dict(args), \
        j_results.new_results_dict(args)
    assert list(mine) == list(theirs) and mine == theirs


def test_each_package_reads_the_others_dumps(tmp_path, capsys):
    """A port dump through JAX's ``load_results`` / ``summarize_directory``
    and a JAX dump through the port's, with ``model_state_dict`` as the JAX
    parameter tree: the weights load into either package."""
    j_tree = j_init_ndcn(jax.random.PRNGKey(0), 1, 8, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_tree))
    mine = fake_run(results, model, 0)
    theirs = fake_run(j_results, j_tree, 1)
    d = str(tmp_path)
    p_mine = results.dump_results(mine, results.results_path(d, "ndcn",
                                                             "port"))
    p_theirs = j_results.dump_results(theirs, j_results.results_path(
        d, "ndcn", "jax"))

    back = j_results.load_results(p_mine)
    assert back["v_iter"] == [10, 20] and back["abs_error"] == \
        mine["abs_error"]
    for a, b in zip(jax.tree_util.tree_leaves(back["model_state_dict"][-1]),
                    jax.tree_util.tree_leaves(j_tree)):
        assert isinstance(a, np.ndarray) and np.array_equal(a, np.asarray(b))
    assert not any(isinstance(x, torch.Tensor)
                   for x in jax.tree_util.tree_leaves(back))
    mine_back = results.load_results(p_theirs)
    assert mine_back["rel_error2"] == theirs["rel_error2"]
    model2 = init_ndcn(torch.Generator().manual_seed(5), 1, 8, 1)
    model_from_jax(mine_back["model_state_dict"][0], model2)
    assert torch.equal(model2.dec.weight, model.dec.weight)

    assert (results.summarize_directory(d, "ndcn")
            == j_results.summarize_directory(d, "ndcn"))
    assert results.summarize_directory(d, "ndcn")["n_runs"] == 2

    # the aggregation's printed form, both packages' entry points
    capsys.readouterr()
    s_mine = summarize.main(["--dir", d, "--type", "ndcn"])
    out_mine = capsys.readouterr().out
    s_theirs = j_summarize.main(["--dir", d, "--type", "ndcn"])
    assert s_mine == s_theirs and out_mine == capsys.readouterr().out
    assert "n_runs: 2" in out_mine and "rel_error2 interpolation" in out_mine


def test_summarize_skips_a_dump_without_evaluations(tmp_path, capsys):
    results.dump_results(results.new_results_dict({}),
                         results.results_path(str(tmp_path), "gru_gnn", "x"))
    s = results.summarize_directory(str(tmp_path), "gru_gnn")
    assert s["n_runs"] == 0 and np.isnan(s["abs_error_mean"])
    assert "skipping" in capsys.readouterr().out


def test_viz_writes_its_pngs(tmp_path, monkeypatch):
    """The five plots (with matplotlib), written where the
    JAX module writes them."""
    monkeypatch.chdir(tmp_path)
    rs = np.random.RandomState(0)
    true_y = rs.rand(25, 4)
    viz.adjacency_heatmap(np.eye(25), "grid")
    viz.dynamics_surfaces("heat", "grid", 5, true_y, true_y[:, -2:])
    viz.surface(5, true_y[:, 0], "one", "heat", "frames")
    viz.error_curves([1, 2], [0.5, 0.4], [0.1, 0.05], "curve")
    viz.frames_to_animation("figure/heat/grid", "*-tru.png", "anim.gif")
    assert os.path.exists("figure/network/grid.png")
    assert len(os.listdir("figure/heat/grid")) == 4 + 2
    for path in ("frames/one.png", "curve.png", "anim.gif"):
        assert os.path.getsize(path) > 0, path


def test_viz_without_matplotlib_prints_and_skips(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    viz.adjacency_heatmap(np.eye(3), "grid")
    assert "matplotlib unavailable" in capsys.readouterr().out
    assert not os.path.exists("figure")


def test_profile_trace_off_and_notify(capsys):
    with timing.profile_trace(None) as path:
        assert path is None
    notify.send_notification("done")
    assert capsys.readouterr().out == "[notify] done\n"


@pytest.mark.parametrize("baseline", ["ndcn", "lstm_gnn"])
def test_profile_dir_leaves_the_losses_bit_equal(baseline, tmp_path):
    """``--profile_dir`` traces three steps on copies (model, optimizer,
    dropout generator): the run's losses equal those without it, bit for
    bit, and the trace exists."""
    argv = HEAT + ["--method", "dopri5", "--baseline", baseline,
                   "--dropout", "0.2"]
    plain = run("heat", build_parser("t").parse_args(argv))
    prof = run("heat", build_parser("t").parse_args(
        argv + ["--profile_dir", str(tmp_path)]))
    assert prof["train_losses"] == plain["train_losses"]
    assert prof["final"] == plain["final"]
    traces = os.listdir(tmp_path)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(tmp_path / traces[0]) > 0


@pytest.mark.parametrize("baseline", ["ndcn", "gru_gnn"])
def test_dump_round_trips(baseline, tmp_path, monkeypatch):
    """``--dump`` records an evaluation at each test_freq (and the NFE of
    the evaluation solve) and dumps the JAX schema that JAX's
    ``load_results`` reads back; ``--viz`` plots beside it."""
    monkeypatch.chdir(tmp_path)
    out = run("heat", build_parser("t").parse_args(
        HEAT + ["--method", "dopri5", "--baseline", baseline, "--dump",
                "--viz", "--results_dir", "res"]))
    path = out["results_path"]
    assert path.startswith("res/result_") and path.endswith("." + baseline)
    r = j_results.load_results(path)
    assert set(j_results.new_results_dict({})) <= set(r)
    assert r["v_iter"] == [2, 4, 6] and len(r["model_state_dict"]) == 3
    assert r["abs_error"][-1] == out["final"]["abs_error"]
    assert r["true_y"][0].shape == (25, 9)   # int(8 * 1.2) points
    assert r["predict_y"][0].shape == (25, 1)
    assert len(r["abs_error2"]) == 3 and r["args"]["baseline"] == baseline
    if baseline == "ndcn":
        assert all(nfe > 0 for nfe in r["nfe_train"])
    else:
        assert r["nfe_train"] == [0, 0, 0] and r["abs_error2"] == [0.0] * 3
        model = init_temporal_gcn(torch.Generator().manual_seed(1), 1, 5, 25,
                                  10, "gru")
        model_from_jax(r["model_state_dict"][-1], model)
    assert r["final"]["abs_error"] == out["final"]["abs_error"]
    assert os.path.exists("figure/network/grid.png")
    assert os.listdir("figure/heat/grid")
