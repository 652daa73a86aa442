"""The benchmark's data, found by the names ``BENCHMARK.json`` gives.

- a configuration: ``BENCHMARK.json``'s ``configs`` entry names its file;
- a traffic mix: ``benchmark/traffic/<traffic>.json``;
- a cell's correctness limits: ``benchmark/limits/<cell>.json``;
- a metric: ``benchmark/metrics/<metric>.py``, a reader with ``read(rec)``
  and the metric's declared ``UNIT``, ``BETTER``, ``SOURCE`` and, for a
  per-layer metric, ``LAYER`` and ``MOVES``, which must agree with
  ``BENCHMARK.json``;
- a dispatch path: ``benchmark/dispatch/<traffic's dispatch>.py``.

Adding a configuration, a mix, a metric or a cell adds files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, NamedTuple

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]     # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_of_cell


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; one of "
                         f"{sorted(entries)}")
    w = entries[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "benchmark"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(root / conf["file"]),
                traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, entry: dict, root: Path = ROOT):
    """The reader module of metric ``name``, checked against its entry."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    declared = {"unit": mod.UNIT, "better": mod.BETTER, "source": mod.SOURCE}
    if hasattr(mod, "LAYER"):
        declared.update(layer=mod.LAYER, moves=mod.MOVES)
    for k, v in declared.items():
        if entry.get(k) != v:
            raise SystemExit(f"metric {name}: BENCHMARK.json says {k} "
                             f"{entry.get(k)!r}, its reader {v!r}")
    return mod


def dispatch(traffic: dict):
    """The ``Session`` class of the traffic's dispatch path."""
    mod = importlib.import_module(f"benchmark.dispatch.{traffic['dispatch']}")
    return mod.Session


def state_width(config: dict) -> int:
    """The width of the solve's state: the hidden width, padded to a
    multiple of 8 in the feature-major layout (its zero rows count in the
    solver's norms)."""
    h = config["model"]["hidden_size"]
    return -(-h // 8) * 8 if config["solver"]["solve_layout"] == \
        "feature_major" else h


def listing(root: Path = ROOT) -> List[Dict[str, object]]:
    """Every cell with the files it resolves to (``--list``)."""
    bench = load_benchmark(root)
    out = []
    for w in bench["workloads"]:
        c = cell(w["name"], root)
        out.append({"workload": w["name"], "config": w["config"],
                    "traffic": w["traffic"], "chips": c.chips,
                    "dispatch": c.traffic["dispatch"],
                    "end_to_end": [m["name"] for m in c.end_to_end],
                    "per_layer": [m["name"] for m in c.per_layer]})
    return out
