"""Adding a configuration, a traffic mix, a per-layer metric and a cell
takes new files and entries only: in a copy of the benchmark, the new
files and a new ``BENCHMARK.json`` entry make the harness list the new
cell, and a run of it on the CPU reports the new metric, with no file of
the copy's harness edited."""

import hashlib
import json
import subprocess
import sys
import time

import torch

from benchmark.run import run_cell
from benchmark.tests import tiny_root

METRIC = '''"""The step budget the probe sized, a test's metric."""

LAYER = "solver loop (ode/adaptive)"
UNIT = "attempts"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "setup_s"


def read(rec):
    return float(rec["max_steps"])
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_needs_new_files_only(tmp_path):
    root = tiny_root.make(tmp_path, with_code=True)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "benchmark/configs/ndcn-heat-grid400.json")
                      .read_text())
    conf.update(name="ndcn-heat-grid144")
    conf["graph"]["side"] = 12
    (root / "benchmark/configs/ndcn-heat-grid144.json").write_text(
        json.dumps(conf))
    mix = json.loads((root / "benchmark/traffic/train-hostloop.json")
                     .read_text())
    mix.update(name="train-hostloop-short", cycle_steps=4)
    (root / "benchmark/traffic/train-hostloop-short.json").write_text(
        json.dumps(mix))
    (root / "benchmark/metrics/budget_attempts.py").write_text(METRIC)
    (root / "benchmark/limits/grid144.train-short.json").write_text(
        (root / "benchmark/limits/grid400.train-graphed.json").read_text())
    bench["configs"].append({
        "name": "ndcn-heat-grid144", "source": "a test's configuration",
        "file": "benchmark/configs/ndcn-heat-grid144.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({
        "name": "grid144.train-short", "config": "ndcn-heat-grid144",
        "traffic": "train-hostloop-short", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "budget_attempts", "unit": "attempts", "better": "lower",
        "source": "program_counter", "layer": "solver loop (ode/adaptive)",
        "moves": "setup_s", "workloads": ["grid144.train-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--list"],
                         cwd=root, capture_output=True, text=True, check=True)
    rows = {r["workload"]: r for r in map(json.loads,
                                          out.stdout.splitlines())}
    new = rows["grid144.train-short"]
    assert new["config"] == "ndcn-heat-grid144"
    assert new["dispatch"] == "host_loop"
    assert "budget_attempts" in new["per_layer"]
    assert "budget_attempts" not in rows["grid400.train-graphed"]["per_layer"]

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        code, result = run_cell("grid144.train-short", 3, 0.2, True,
                                device="cpu", root=root, t_start=time.time())
    finally:
        torch.set_num_threads(prev)
    assert code == 0 and result["correct"] is True
    assert result["metrics"]["budget_attempts"]["value"] >= 8
    changed = {k for k, v in _digests(root).items() if before.get(k) != v}
    assert changed == {"benchmark/configs/ndcn-heat-grid144.json",
                       "benchmark/traffic/train-hostloop-short.json",
                       "benchmark/metrics/budget_attempts.py",
                       "benchmark/limits/grid144.train-short.json"}
