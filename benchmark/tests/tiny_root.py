"""A copy of the benchmark's data (``BENCHMARK.json`` and the configs,
mixes, limits and metric readers) with every configuration cut to a size
the CPU runs in seconds, for the tests that drive whole runs there. The
widths, solver settings, limits and metrics are the cells' own, and so is the
grid cell's configuration; the random graph has 20,000 nodes and the
cycles 6 steps. The random graph's feature-major solve needs the card, so
the copy states its (n, d) layout. (On fewer nodes, or a coarser time
grid, Adam's steps of near-zero gradient elements move the later steps by
more than the cells' limits allow a sound run: ``check.py``.)"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.spec import ROOT

DATA = ("configs", "traffic", "limits", "metrics")


def make(dest: Path, with_code: bool = False) -> Path:
    """The cut copy under ``dest``; with ``with_code`` the benchmark's
    Python package too (for a run in a process started there)."""
    bench = dest / "benchmark"
    if with_code:
        shutil.copytree(ROOT / "benchmark", bench,
                        ignore=shutil.ignore_patterns("__pycache__"))
    else:
        for sub in DATA:
            shutil.copytree(ROOT / "benchmark" / sub, bench / sub,
                            ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        if c["graph"]["kind"] == "random":
            c["graph"]["n"] = 20_000
            c["solver"]["solve_layout"] = "nd"
        path.write_text(json.dumps(c))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(cycle_steps=6, steps_per_read=3, trace_steps=3)
        path.write_text(json.dumps(t))
    return dest


def cells(root: Path) -> list:
    return [w["name"] for w in
            json.loads((root / "BENCHMARK.json").read_text())["workloads"]]
