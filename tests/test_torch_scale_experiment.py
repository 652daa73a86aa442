"""The scale experiment (``experiments/large_graph.py``) and the sparse
microbenchmarks on the CPU, against the JAX example and numpy oracles.

- ``build_sparse_graph`` bit-equal to ``examples/large_graph.py``'s;
- the experiment at 3000 nodes: the example's record keys, a falling loss, the
  bf16 levers, ``--estimate``'s counted tape, a ``--gt_cache`` written by
  the JAX example (port ground truth within 1e-5 rel-L1 of it), and each
  refusal naming its ROADMAP item;
- P1a's inline packing slot for slot against the tool's loop packing, and
  its plain reduce within 1e-5 max|Δ|/max|y| of a float64 oracle; the row
  gather's plain version exact.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.graph import sparse as gs
from ndcn_tpu_torch.kernels import coo_spmv as ck


def rel_l1(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _power_law_coo(n, m_edges, seed):
    rng = np.random.RandomState(seed)
    rows = rng.zipf(1.5, m_edges) % n
    cols = rng.randint(0, n, m_edges)
    a = sp.coo_matrix((rng.randn(m_edges).astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a



def _example():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "large_graph_example",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                     "examples", "large_graph.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,deg,seed", [(20000, 10, 0), (257, 4, 3)])
def test_build_sparse_graph_bit_equal_to_the_example(n, deg, seed):
    from ndcn_tpu_torch.graph.generators import build_sparse_graph

    ours = build_sparse_graph(n, deg, seed)
    ref = _example().build_sparse_graph(n, deg, seed)
    assert (ours != ref).nnz == 0 and ours.dtype == ref.dtype
    assert np.array_equal(ours.indptr, ref.indptr)


# the JAX example's record keys (examples/large_graph.py:692-713)
RECORD_KEYS = {
    "n_nodes", "nnz", "train_steps_per_sec", "node_evals_per_sec",
    "ground_truth_s", "rel_loss_initial", "rel_loss_final", "device", "fmt",
    "dynamics", "max_steps", "elastic_rollbacks", "mesh_devices",
    "mesh_parity", "hbm_peak_gb", "hbm_peak_source", "roofline",
    "hbm_program_gb", "hbm_breakdown_gb", "layout", "kernel_precision",
    "emission_precision", "residual_precision", "iters", "hidden"}
SMALL = ["--platform", "cpu", "--n", "3000"]


def test_scale_experiment_runs_on_the_cpu_with_the_example_record(tmp_path):
    from ndcn_tpu_torch.experiments import large_graph

    out = tmp_path / "rec.json"
    rec = large_graph.main(SMALL + ["--iters", "2", "--roofline",
                                    "--hbm_probe", "--out", str(out)])
    assert RECORD_KEYS <= set(rec)
    assert rec["n_nodes"] == 3000 and rec["device"] == "cpu"
    assert rec["solve_layout"] == "nd"          # auto: below 500k, and CPU
    assert np.isfinite(rec["rel_loss_final"]) and rec["max_steps"] >= 8
    assert rec["roofline"] is None and rec["hbm_peak_gb"] is None
    assert rec["train_losses"][-1] < rec["train_losses"][0]
    assert json.loads(out.read_text())["argv"] is not None


def test_scale_experiment_bf16_levers_train(monkeypatch):
    from ndcn_tpu_torch.experiments import large_graph

    rec = large_graph.main(SMALL + [
        "--iters", "2", "--kernel_precision", "bf16", "--emission_precision",
        "bf16", "--residual_precision", "bf16"])
    assert np.isfinite(rec["rel_loss_final"])
    assert rec["train_losses"][-1] < rec["train_losses"][0]
    assert ck.GATHER_BF16 is False            # restored after the run


def test_scale_experiment_estimate_counts_the_tape(capsys):
    """--estimate: the census's tape term, counted on the proxy, scales
    with n and the budget; the bf16 residual keeps fewer bytes."""
    from ndcn_tpu_torch.experiments import large_graph

    est = large_graph.main(SMALL + ["--estimate"])
    assert est["layout"] == "nd" and est["max_steps"] >= 8
    assert est["hbm_limit_gb"] is None and est["fits"] is None
    per = est["tape_bytes_per_node_attempt"]
    # the (n, 20) state is 80 bytes a node: tens of states per attempt
    assert 20 * 80 < per < 100 * 80
    assert est["terms_gb"]["tape"] == pytest.approx(
        per * 3000 * est["max_steps"] / 1e9, rel=1e-2, abs=1e-3)
    bf = large_graph.main(SMALL + ["--estimate", "--residual_precision",
                                   "bf16"])
    assert bf["tape_bytes_per_node_attempt"] < per
    assert "estimate_gb" in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


def test_scale_experiment_reads_a_ground_truth_cache_written_by_jax(tmp_path):
    from ndcn_tpu_torch.experiments import large_graph

    cache = str(tmp_path / "gt.npz")
    _example().main(["--n", "3000", "--platform", "cpu", "--gt_only",
                     "--gt_cache", cache])
    mine = str(tmp_path / "gt_port.npz")
    rec = large_graph.main(SMALL + ["--gt_only", "--gt_cache", mine])
    assert rec["gt_only"] and not rec["cached"]
    a, b = np.load(cache), np.load(mine)
    assert set(a.files) == set(b.files)
    assert rel_l1(b["truth"], a["truth"]) <= 1e-5
    rec = large_graph.main(SMALL + ["--iters", "1", "--gt_cache", cache])
    assert rec["ground_truth_s"] == 0.0 and np.isfinite(rec["rel_loss_final"])
    with pytest.raises(SystemExit, match="different run parameters"):
        large_graph.main(["--platform", "cpu", "--n", "3000", "--seed", "1",
                          "--gt_cache", cache])


@pytest.mark.parametrize("extra,err,match", [
    (["--dynamics", "mutualistic"], None, "coo"),
    (["--dynamics", "gene"], None, "coo"),
    (["--fmt", "ell"], None, "ell"),
    (["--mesh"], NotImplementedError, "item 8"),
    (["--precision", "high"], NotImplementedError, "item 4"),
    (["--gt_only"], SystemExit, "--gt_cache"),
])
def test_scale_experiment_refusals_name_their_item(extra, err, match):
    """What the port lacks raises naming its ROADMAP item; the dynamics and
    the format that the port has (``err`` None) run one step, on the
    format ``match``."""
    from ndcn_tpu_torch.experiments import large_graph

    if err is None:
        rec = large_graph.main(SMALL + extra + ["--iters", "1"])
        assert rec["fmt"] == match and rec["solve_layout"] == "nd"
        assert np.isfinite(rec["rel_loss_final"]) and rec["attempts_taken"] > 0
        return
    with pytest.raises(err, match=match):
        large_graph.main(SMALL + extra)


def test_scale_experiment_and_tools_need_the_card_on_gpu():
    from ndcn_tpu_torch.experiments import large_graph
    from ndcn_tpu_torch.tools import (bench_wide_gather, microbench_sparse,
                                      probe_inkernel_gather)
    from ndcn_tpu_torch.train import roofline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA device"):
        large_graph.main(["--n", "100"])
    for tool in (microbench_sparse, probe_inkernel_gather, bench_wide_gather):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tool.main([])
    a = _power_law_coo(50, 200, seed=0)
    with pytest.raises(RuntimeError, match="on the card"):
        roofline.measure_spmv(gs.from_scipy_coo(a), 20)
    assert roofline.gather_floor_s(20, {"spmv_fwd_ms": 1.5,
                                        "spmv_t_ms": 2.5}) == pytest.approx(
        0.08)


# ------------------------------------------------------- the microbenchmarks


@pytest.mark.parametrize("n,R,E", [(5000, 128, 2048), (3000, 64, 512),
                                   (700, 256, 300)])
def test_sliced_tile_packing_and_plain_reduce_match_the_oracle(n, R, E):
    """P1a's inline packing (tools/microbench_sparse.py:164-195) and its
    plain reduce, against the numpy oracle and against the example's loop
    packing, slot for slot."""
    from ndcn_tpu_torch.kernels import sparse_bench

    rng = np.random.RandomState(n)
    nnz = n * 11
    rows = np.sort(np.concatenate([rng.randint(0, n, nnz - 2500),
                                   np.full(2500, 3)])).astype(np.int32)
    cols = rng.randint(0, n, nnz).astype(np.int32)
    vals = rng.rand(nnz).astype(np.float32)
    d = 20
    x = rng.rand(n, d).astype(np.float32)
    tiles = sparse_bench.pack_sliced_tiles(rows, cols, vals, n, R, E)
    # the tool's loop packing, as written there
    T = -(-n // R)
    starts = np.searchsorted(rows, np.arange(T) * R)
    ends = np.searchsorted(rows, (np.arange(T) + 1) * R)
    slices = []
    for tile in range(T):
        lo = starts[tile]
        if lo == ends[tile]:
            slices.append((tile, lo, lo))
            continue
        while lo < ends[tile]:
            hi = min(lo + E, ends[tile])
            slices.append((tile, lo, hi))
            lo = hi
    lr = np.zeros((len(slices), E), np.int32)
    cc = np.zeros((len(slices), E), np.int32)
    for i, (tl, lo, hi) in enumerate(slices):
        lr[i, :hi - lo] = rows[lo:hi] - tl * R
        cc[i, :hi - lo] = cols[lo:hi]
    assert np.array_equal(tiles.local_rows.numpy(), lr.ravel())
    assert np.array_equal(tiles.cols.numpy(), cc.ravel())
    tile_of = np.array([s[0] for s in slices])
    ptr = tiles.tile_ptr.numpy()
    assert np.array_equal(np.repeat(np.arange(T), np.diff(ptr)), tile_of)

    d_sub = ck.sublane_pad(d)
    xT = np.zeros((d_sub, n), np.float32)
    xT[:d] = x.T
    contrib = torch.as_tensor(xT)[:, tiles.cols.long()]
    out = sparse_bench.sliced_tile_reduce(tiles, contrib)
    assert out.shape == (d_sub, T * R)
    oracle = (sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                            shape=(n, n)) @ x.astype(np.float64))
    assert max_rel(out[:d, :n].numpy().T, oracle) <= 1e-5
    assert not out[d:].any() and not out[:, n:].any()


def test_row_gather_plain_and_checks():
    from ndcn_tpu_torch.kernels import sparse_bench

    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.rand(1024, 128).astype(np.float32))
    idx = torch.as_tensor(rng.randint(0, 1024, 512).astype(np.int32))
    assert torch.equal(sparse_bench.row_gather(x, idx),
                       torch.as_tensor(x.numpy()[idx.numpy()]))
    with pytest.raises(ValueError, match="int32"):
        sparse_bench.row_gather(x, idx.long())
    with pytest.raises(ValueError, match="float32"):
        sparse_bench.row_gather(x[:, :6], idx)
    with pytest.raises(ValueError, match="row-sorted"):
        sparse_bench.pack_sliced_tiles(np.array([3, 1]), np.array([0, 0]),
                                       np.ones(2, np.float32), 5)
