"""A short run of each cell on the card (skips without one): correct, with
the contract's keys, the card named, nothing failed."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.spec import ROOT
from benchmark.tests import tiny_root


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny_root.cells(ROOT))
def test_a_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the run measures the card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == 1
    assert list(result)[-1] == "check"


def test_without_a_card_the_run_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         tiny_root.cells(ROOT)[0], "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_alone_the_benchmark_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         tiny_root.cells(ROOT)[0], "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
