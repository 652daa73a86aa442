"""The port's T × alpha sweep (``experiments.sweep_t_alpha``) against the
JAX package's, on a synthetic Planetoid graph (300 nodes, 2 epochs a
cell): the CSV is the JAX sweep's byte for byte at the same cell
accuracies, ``--resume`` reruns no finished cell, a sweep without it starts
a fresh cell log, and the figures are written."""

import os
import sys
import types

import numpy as np
import pytest
import torch

from ndcn_tpu.experiments import dgnn as j_dgnn
from ndcn_tpu.experiments import sweep_t_alpha as j_sweep
from ndcn_tpu_torch.experiments import dgnn, sweep_t_alpha

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ["--T_values", "1.2", "--alpha_values", "0.0", "1.0"]


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

    d = str(tmp_path_factory.mktemp("sweep"))
    make_dataset("sweep_torch", n=300, n_features=64, n_classes=5, out_dir=d,
                 seed=0, n_test=60)
    return d


def argv(synth_dir, out_csv, *extra):
    return [*GRID, "--dataset", "sweep_torch", "--data_dir", synth_dir,
            "--epochs", "2", "--hidden", "8", "--time_tick", "4", "--method",
            "euler", "--platform", "cpu", "--out_csv", out_csv, *extra]


def counting_stub(accs):
    """A stand-in for a driver's ``run``: the next accuracy of ``accs`` as
    its one row; ``calls`` holds each cell's (T, alpha)."""
    it = iter(accs)
    calls = []

    def run(args):
        calls.append((args.T, args.alpha))
        return {"rows": [(0.0, 1.0, next(it), 0.0)]}

    return types.SimpleNamespace(run=run, calls=calls)


def test_grid_csv_is_the_jax_sweeps(synth_dir, tmp_path, monkeypatch):
    """A real 1 × 2 sweep through the port's dgnn driver; the JAX sweep
    given the same cell accuracies writes the same bytes."""
    mine = str(tmp_path / "mine.csv")
    grid = sweep_t_alpha.main(argv(synth_dir, mine))
    assert grid.shape == (1, 2) and np.all((grid >= 0) & (grid <= 1))
    stub = counting_stub(grid.ravel().tolist())
    monkeypatch.setattr(j_dgnn, "run", stub.run)
    theirs = str(tmp_path / "theirs.csv")
    j_sweep.main(argv(synth_dir, theirs))
    assert stub.calls == [(1.2, 0.0), (1.2, 1.0)]
    with open(mine) as a, open(theirs) as b:
        text = a.read()
        assert text == b.read()
    assert text.splitlines()[0] == "T\\alpha,0.0,1.0"
    with open(mine + ".cells") as a, open(theirs + ".cells") as b:
        assert a.read() == b.read()


def test_resume_reruns_no_cell(synth_dir, tmp_path, monkeypatch):
    out_csv = str(tmp_path / "grid.csv")
    first = counting_stub([0.5, 0.75])
    monkeypatch.setattr(dgnn, "run", first.run)
    grid = sweep_t_alpha.main(argv(synth_dir, out_csv))
    assert len(first.calls) == 2

    again = counting_stub([])
    monkeypatch.setattr(dgnn, "run", again.run)
    resumed = sweep_t_alpha.main(argv(synth_dir, out_csv, "--resume"))
    assert again.calls == [] and np.array_equal(resumed, grid)

    # a sweep cut after its first cell resumes at the second
    with open(out_csv + ".cells") as f:
        first_line = f.readline()
    with open(out_csv + ".cells", "w") as f:
        f.write(first_line)
    rest = counting_stub([0.75])
    monkeypatch.setattr(dgnn, "run", rest.run)
    assert np.array_equal(
        sweep_t_alpha.main(argv(synth_dir, out_csv, "--resume")), grid)
    assert rest.calls == [(1.2, 1.0)]


def test_without_resume_the_cell_log_is_removed(synth_dir, tmp_path,
                                                monkeypatch):
    out_csv = str(tmp_path / "grid.csv")
    with open(out_csv + ".cells", "w") as f:
        f.write("1.2,0.0,0.999000,0.000000\n")
    stub = counting_stub([0.5, 0.75])
    monkeypatch.setattr(dgnn, "run", stub.run)
    grid = sweep_t_alpha.main(argv(synth_dir, out_csv, "--heatmap",
                                   "--surface", "--errorbar"))
    assert len(stub.calls) == 2 and grid.tolist() == [[0.5, 0.75]]
    with open(out_csv + ".cells") as f:
        assert f.read() == ("1.2,0.0,0.500000,0.000000\n"
                            "1.2,1.0,0.750000,0.000000\n")
    for suffix in (".png", "_3d.png", "_errorbar.png"):
        assert os.path.getsize(out_csv.replace(".csv", suffix)) > 0, suffix


def test_replica_cells_and_no_card_are_refused(synth_dir, tmp_path):
    """Cells of several replicas with an Adams method, refused until
    ROADMAP §1 entry 11a′ was ported, run (two replicas a cell, the dgnn
    driver's batched adams); the default platform needs a card."""
    out_csv = str(tmp_path / "grid.csv")
    grid = sweep_t_alpha.main(argv(synth_dir, out_csv, "--batch_iters",
                                   "--iter", "2", "--method", "adams"))
    assert grid.shape == (1, 2) and np.isfinite(grid).all()
    no_platform = [a for a in argv(synth_dir, out_csv)
                   if a not in ("--platform", "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep_t_alpha.main(no_platform)
