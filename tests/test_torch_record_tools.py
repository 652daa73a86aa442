"""The port's scale-record tools, ``analyze_mesh_tax`` and the quickstart
against the JAX repository's root ``tools/`` and ``examples/quickstart.py``
(CPU; the plain versions of the kernels).

- ``bench_scale`` and ``record_showcase``: with the driver monkeypatched in
  both the JAX tool (loaded by path) and the port's, the argv each builds
  is the same apart from ``--platform``, and the port's record holds the
  JAX record's fields and ``card``.
- ``check_scale_records``: the gate passes 5 % slower, fails 25 % slower,
  strips ``--out`` / ``--iters`` and the probes, and says when the cards
  differ (as ``tests/test_perf_records.py`` holds the JAX tool).
- ``profile_scale_step`` at 2,000 nodes: ``nfe``, ``max_steps`` and
  ``resolved_layout`` equal to the JAX package's ``ndcn_forward`` and
  ``probe_step_budget`` at the same weights; its keys hold the JAX tool's.
- ``analyze_mesh_tax`` on a one-rank gloo group at 2,000 nodes: the
  sharded variants' NFE equal to the unsharded ones' and their losses
  within 1e-5.
- the quickstart: its ground truth within 1e-4 rel-L1 of
  ``ndcn_tpu.odeint``'s, its first step's loss and gradients within 1e-4 /
  1e-3 of JAX's at the converted weights.
- the committed ``results_torch/`` records: the card and its power limit,
  an argv the port's scale driver accepts, their sizes and fields.
"""

import glob
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # many small solves: torch's thread pool only contends with the other
    # test workers' (tests/test_torch_dynamics.py)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _load_jax_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _without_platform(argv):
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--platform":
            i += 2
            continue
        out.append(argv[i])
        i += 1
    return out


def _rel_l1(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


FAKE_RUN = {"train_steps_per_sec": 2.0, "rel_loss_final": 0.05,
            "device": "FAKE", "hbm_peak_gb": 1.0, "estimate_gb": 2.0,
            "fits": True, "layout": "nd", "mesh_devices": 1}


def test_bench_scale_builds_the_jax_tools_argv(monkeypatch, tmp_path):
    from ndcn_tpu_torch.tools import bench_scale

    jax_tool = _load_jax_tool("bench_scale")
    seen = {"jax": [], "port": []}

    def fake(which):
        def run_demo(argv, timeout_s):
            seen[which].append(list(argv))
            return dict(FAKE_RUN)
        return run_demo

    monkeypatch.setattr(jax_tool, "run_demo", fake("jax"))
    monkeypatch.setattr(bench_scale, "run_demo", fake("port"))
    passthrough = ["--gt_cache", "/tmp/gt.npz", "--kernel_precision", "bf16",
                   "--roofline", "--hbm_probe", "--mesh", "--platform", "cpu"]
    jax_tool.main(["--n", "200000", "--out", str(tmp_path / "jax.json"),
                   *passthrough])
    rec = bench_scale.main(["--n", "200000", "--out",
                            str(tmp_path / "port.json"), *passthrough])
    # the estimate, then the measured run: once in JAX, --repeats (3) times
    # in the port
    assert len(seen["jax"]) == 2 and len(seen["port"]) == 4
    for j, p in zip([seen["jax"][0]] + [seen["jax"][1]] * 3, seen["port"]):
        assert _without_platform(j) == _without_platform(p)
    with open(tmp_path / "jax.json") as f:
        jax_rec = json.load(f)
    with open(tmp_path / "port.json") as f:
        port_rec = json.load(f)
    assert set(jax_rec) | {"card", "runs_steps_per_sec"} == set(port_rec) \
        == set(rec)
    assert port_rec["argv"][:4] == ["--n", "200000", "--dynamics", "heat"]
    assert port_rec["card"] is None               # --platform cpu
    # the default path: results_torch/, not the JAX package's results/
    monkeypatch.setattr(bench_scale, "REPO", str(tmp_path))
    bench_scale.main(["--n", "50000", "--dynamics", "mutualistic",
                      "--skip_estimate", "--platform", "cpu"])
    assert (tmp_path / "results_torch" / "scale_50k_mutualistic.json") \
        .exists()
    # without --platform cpu it measures the card, and refuses without one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_scale.main(["--n", "1000", "--out",
                              str(tmp_path / "x.json")])


def test_bench_scale_keeps_the_median_run(monkeypatch, tmp_path):
    from ndcn_tpu_torch.tools import bench_scale

    readings = iter([9.0, 13.0, 10.0])

    def run_demo(argv, timeout_s):
        return dict(FAKE_RUN, train_steps_per_sec=next(readings),
                    iters=len(argv))

    monkeypatch.setattr(bench_scale, "run_demo", run_demo)
    rec = bench_scale.main(["--n", "200000", "--skip_estimate", "--platform",
                            "cpu", "--out", str(tmp_path / "r.json")])
    assert rec["runs_steps_per_sec"] == [9.0, 13.0, 10.0]
    assert rec["measured"]["train_steps_per_sec"] == 10.0
    with open(tmp_path / "r.json") as f:
        assert json.load(f) == rec


@pytest.mark.parametrize("batch", [True, False])
def test_record_showcase_builds_the_jax_tools_recipe(monkeypatch, tmp_path,
                                                     batch):
    import ndcn_tpu.experiments.dgnn as jax_dgnn
    import ndcn_tpu_torch.experiments.dgnn as port_dgnn
    from ndcn_tpu_torch.tools import record_showcase

    jax_tool = _load_jax_tool("record_showcase")
    seen = {}
    summary = {"rows": [(1.0, 0.5, 0.82, 0.0), (1.0, 0.5, 0.84, 0.0)],
               "total_time": 3.0, "acc_mean": 0.83, "acc_std": 0.014,
               "acc_median": 0.83, "acc_min": 0.82, "acc_max": 0.84,
               "device": "cpu"}

    def fake(which):
        def main(argv):
            seen[which] = list(argv)
            return dict(summary)
        return main

    monkeypatch.setattr(jax_dgnn, "main", fake("jax"))
    monkeypatch.setattr(port_dgnn, "main", fake("port"))
    flags = ["--iter", "4", "--epochs", "20", "--platform", "cpu",
             *(["--batch_iters"] if batch else [])]
    monkeypatch.setattr(sys, "argv", ["record_showcase", *flags, "--out",
                                      str(tmp_path / "jax.json")])
    jax_tool.main()
    rec = record_showcase.main([*flags, "--out", str(tmp_path / "p.json")])
    assert _without_platform(seen["jax"]) == _without_platform(seen["port"])
    assert ("--batch_iters" in seen["port"]) == batch
    assert ("--dump" in seen["port"]) != batch
    with open(tmp_path / "jax.json") as f:
        jax_rec = json.load(f)
    assert set(jax_rec) <= set(rec) and rec["card"] is None
    assert rec["per_iter_acc"] == [0.82, 0.84]
    assert rec["recipe"] == seen["port"]
    monkeypatch.setattr(record_showcase, "REPO", str(tmp_path))
    record_showcase.main(flags)
    name = "showcase_cora_4.json" if batch else "showcase_cora.json"
    assert (tmp_path / "results_torch" / name).exists()


def test_check_scale_records_gate(monkeypatch, tmp_path, capsys):
    from ndcn_tpu_torch.tools import check_scale_records as tool

    assert tool.strip_flag(["--a", "1", "--out", "x.json", "--b"], "--out") \
        == ["--a", "1", "--b"]
    rec = {"measured": {"train_steps_per_sec": 2.0},
           "argv": ["--n", "1000", "--out", "old.json", "--iters", "60",
                    "--roofline", "--hbm_probe", "--gt_cache", "g.npz"],
           "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    rec_path = tmp_path / "scale_fake.json"
    rec_path.write_text(json.dumps(rec))
    seen = {}

    def fake_rerun(argv, iters, timeout_s):
        seen["argv"], seen["iters"] = argv, iters
        return {"train_steps_per_sec": fake_rerun.value, "device": "FAKE"}

    monkeypatch.setattr(tool, "rerun", fake_rerun)
    monkeypatch.setattr(tool, "REPO", "/")
    monkeypatch.setattr(tool, "card", lambda: "NVIDIA H100 80GB HBM3, 500 W")

    fake_rerun.value = 1.9          # 5 % slower: within the 10 % gate
    monkeypatch.setattr(tool, "require_cuda", lambda: None)
    lines = tool.main(["--records", str(rec_path)])
    # the ground-truth cache moved under the checkout's build/
    assert seen["argv"] == ["--n", "1000", "--gt_cache",
                            os.path.join("/", "build", "gt_cache", "g.npz")]
    assert seen["iters"] == 20
    assert lines[0]["status"] == "OK" and lines[0]["cards_differ"]
    assert lines[0]["record_card"] == rec["card"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["card"] == "NVIDIA H100 80GB HBM3, 500 W"

    fake_rerun.value = 1.5          # 25 % slower: a regression
    with pytest.raises(SystemExit, match="scale regression"):
        tool.main(["--records", str(rec_path)])
    # --platform cpu runs the records' argv on the CPU
    fake_rerun.value = 2.0
    lines = tool.main(["--records", str(rec_path), "--platform", "cpu"])
    assert seen["argv"][-2:] == ["--platform", "cpu"]
    assert lines[0]["card"] is None


def test_profile_scale_step_matches_jax(monkeypatch):
    import jax
    import jax.numpy as jnp

    from ndcn_tpu.graph.sparse import as_operator as j_as_operator
    from ndcn_tpu.models import init_ndcn as j_init_ndcn
    from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
    from ndcn_tpu.train.budget import probe_step_budget as j_budget
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import normalized_laplacian_sparse
    from ndcn_tpu_torch.tools import profile_scale_step as tool

    monkeypatch.setattr(tool, "WARM", 0)
    monkeypatch.setattr(tool, "REPS", 1)
    args = tool.build_parser().parse_args(
        ["--n", "2000", "--platform", "cpu", "--kernel_precision", "split2"])
    j_params = j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    got = tool.profile(args, model=model)

    problem = large_graph.build_problem(tool.driver_args(args),
                                        torch.device("cpu"))
    j_op = j_as_operator(normalized_laplacian_sparse(
        build_sparse_graph(2000, 10, 0)), sparse=True, format="coo")
    box = []

    @jax.jit
    def j_stats(p):
        return j_ndcn_forward(p, j_op, jnp.asarray(problem.t_train),
                              jnp.asarray(problem.x0.numpy()), rtol=0.01,
                              atol=0.001, method="dopri5", max_steps=1 << 14,
                              nondiff=True)[1]

    def probe():
        box.append(j_stats(j_params))
        return box[-1]

    budget = j_budget(probe, floor=8, headroom=2.5, slack=4, quantum=4)
    assert got["nfe"] == int(box[0].nfe)
    assert got["max_steps"] == budget
    assert got["resolved_layout"] == "nd"     # JAX's at 2,000 nodes too
    assert got["train_solve"] == "host_loop"
    for key in ("spmv_ms", "rhs_ms", "fwd_while_ms", "fwd_scan_ms",
                "grad_ms", "step_ms"):
        assert got[key] > 0, key
    with open(os.path.join(REPO, "tools", "profile_scale_step.py")) as f:
        jax_keys = set(re.findall(r'results\["(\w+)"\]', f.read()))
    assert jax_keys and jax_keys <= set(got)


def test_analyze_mesh_tax_one_rank_gloo(tmp_path):
    from ndcn_tpu_torch.tools import analyze_mesh_tax

    out = analyze_mesh_tax.main(
        ["--n", "2000", "--platform", "cpu", "--hist",
         str(tmp_path / "tax"), "--out", str(tmp_path / "tax.json")])
    v = out["variants"]
    assert set(v) == set(analyze_mesh_tax.VARIANTS)
    assert out["world"] == 1 and out["backend"] == "gloo"
    for whole, sharded in (("step_u", "step_s"), ("step_u", "step_so"),
                           ("fwd_u", "fwd_s")):
        assert v[sharded]["nfe"] == v[whole]["nfe"]
        assert abs(v[sharded]["loss"] - v[whole]["loss"]) \
            <= 1e-5 * abs(v[whole]["loss"])
        assert v[sharded]["success"]
    # the sharded variants run their collectives over the world group
    assert v["step_s"]["collectives"] and not v["step_u"]["collectives"]
    with open(tmp_path / "tax_step_s.kernels.json") as f:
        assert set(json.load(f)) >= {"kernels", "collectives",
                                     "port_launches"}
    with pytest.raises(SystemExit, match="not ported"):
        analyze_mesh_tax.main(["--n", "2000", "--platform", "cpu",
                               "--variants", "step_sd"])


def test_quickstart_matches_jax():
    import jax
    import jax.numpy as jnp

    import ndcn_tpu
    from ndcn_tpu.dynamics import make_rhs as j_make_rhs
    from ndcn_tpu.graph import generators as j_gen
    from ndcn_tpu.graph import operators as j_ops
    from ndcn_tpu.graph.sparse import from_dense as j_from_dense
    from ndcn_tpu.models import init_ndcn as j_init_ndcn
    from ndcn_tpu.models import ndcn_forward as j_ndcn_forward
    from ndcn_tpu.train.losses import l1_loss as j_l1_loss
    from ndcn_tpu_torch.convert import params_from_jax
    from ndcn_tpu_torch.experiments import quickstart

    adj = j_gen.build_network("grid", 400, seed=0)
    x0 = jnp.asarray(j_gen.grid_block_initial_value(20))
    t = jnp.linspace(0.0, 5.0, 50)
    truth = ndcn_tpu.odeint(
        j_make_rhs("heat", j_from_dense(j_ops.laplacian_dense(adj))), x0, t,
        rtol=1e-7, atol=1e-9, method="dopri5",
        options={"differentiable": False})
    op, t_p, x0_p, truth_p = quickstart.problem(torch.device("cpu"),
                                                t=np.asarray(t))
    assert _rel_l1(truth_p.numpy(), truth) <= 1e-4

    j_params = j_init_ndcn(jax.random.PRNGKey(0), 1, 20, 1)
    j_op = j_from_dense(j_ops.normalized_laplacian(adj))

    def j_loss(p):
        pred, stats = j_ndcn_forward(p, j_op, t, x0, rtol=0.01, atol=0.001,
                                     method="dopri5",
                                     max_steps=quickstart.MAX_STEPS)
        loss = j_l1_loss(pred, truth)
        return jnp.where(stats.success, loss, jnp.nan)

    j_val, j_grads = jax.jit(jax.value_and_grad(j_loss))(j_params)
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params))
    # the port's loss on its own truth, as the quickstart trains
    loss, rel = quickstart.objective(model, op, t_p, x0_p, truth_p)()
    loss.backward()
    assert np.isfinite(float(j_val))
    assert abs(loss.item() - float(j_val)) <= 1e-4 * abs(float(j_val))
    for name in ("enc1", "enc2", "wt", "dec"):
        layer = getattr(model, name)
        assert _rel_l1(layer.weight.grad.numpy().T, j_grads[name]["w"]) \
            <= 1e-3, name
        assert _rel_l1(layer.bias.grad.numpy(), j_grads[name]["b"]) \
            <= 1e-3, name
    # the script itself: a few steps on the CPU, finite at each report
    report = quickstart.main(iters=4, platform="cpu", every=2)
    assert report["iter"] == [2, 4] and np.all(np.isfinite(report["loss"]))


def _port_records(pattern):
    return sorted(glob.glob(os.path.join(REPO, "results_torch", pattern)))


def _check_card(rec, path):
    assert rec.get("card") and "NVIDIA" in rec["card"], path
    assert re.search(r"\d+(\.\d+)? W$", rec["card"]), (path, rec["card"])


def test_committed_port_scale_records_schema():
    from ndcn_tpu_torch.experiments.large_graph import build_parser

    paths = _port_records("scale_*.json")
    assert {os.path.basename(p) for p in paths} >= {
        "scale_200k_heat.json", "scale_200k_heat_mesh.json",
        "scale_1m_heat.json", "scale_50k_mutualistic.json"}
    for path in paths:
        with open(path) as f:
            rec = json.load(f)
        _check_card(rec, path)
        measured = rec["measured"]
        assert measured["train_steps_per_sec"] > 0, path
        assert measured["n_nodes"] >= 50_000, path
        assert "NVIDIA" in measured["device"], path
        args = build_parser().parse_args(rec["argv"])
        assert args.n == measured["n_nodes"], path
        # the baseline is the median of three runs or more, and the ground
        # truth is cached inside the checkout
        runs = rec["runs_steps_per_sec"]
        assert len(runs) >= 3, path
        assert measured["train_steps_per_sec"] == sorted(runs)[
            len(runs) // 2], path
        assert args.gt_cache is None or not os.path.isabs(args.gt_cache), path
        assert rec["estimate"]["n_nodes"] == measured["n_nodes"], path
        if os.path.basename(path) == "scale_200k_heat_mesh.json":
            assert args.mesh and measured["mesh_devices"] == 1, path
        if os.path.basename(path) == "scale_1m_heat.json":
            roof = measured.get("roofline")
            assert roof and roof["pct_of_gather_floor"] > 0, path
            assert measured.get("hbm_peak_gb"), path
            assert measured["solve_layout"] == "feature_major", path


def test_committed_port_showcase_and_mesh_tax_records():
    (path,) = _port_records("showcase_cora_100.json")
    with open(path) as f:
        rec = json.load(f)
    _check_card(rec, path)
    assert rec["n_models"] == 100 and len(rec["per_iter_acc"]) == 100
    assert "--batch_iters" in rec["recipe"]
    # the JAX record's 0.8317 (a TPU run) +- 3 standard errors of its std
    with open(os.path.join(REPO, "results", "showcase_cora_100.json")) as f:
        ref = json.load(f)
    bar = 3 * ref["acc_std"] / np.sqrt(rec["n_models"])
    assert abs(rec["acc_mean"] - ref["acc_mean"]) <= bar, \
        (rec["acc_mean"], ref["acc_mean"], bar)
    (path,) = _port_records("mesh_tax_200k.json")
    with open(path) as f:
        tax = json.load(f)
    _check_card(tax, path)
    assert tax["n"] == 200_000
    v = tax["variants"]
    assert {"step_u", "step_s", "fwd_u", "fwd_s"} <= set(v)
    assert v["step_s"]["nfe"] == v["step_u"]["nfe"]
    assert v["step_s"]["port_launches"].get("coo_spmv_rowblock", 0) > 0
