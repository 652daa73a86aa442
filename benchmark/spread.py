"""The spread of end-to-end metrics over sets of runs, which the bounds in
``BENCHMARK.json`` are set from.

    python3 -m benchmark.spread SET_FILE [SET_FILE ...]

Each file holds the result lines of one set of runs (the last line of each
run's standard output, one per line). A spread is the distance between the
first and the third quartile, as ``statistics.quantiles(values, n=4)``
gives them, over the median. For each metric it prints each set's median
and spread, the same with each set's run farthest from its median left
out, the spread of all runs together, and five times the widest set's
spread (at least 1 %), the bound that rule gives.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def read_set(path: str) -> Dict[str, List[float]]:
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            for name, m in json.loads(line)["metrics"].items():
                out.setdefault(name, []).append(float(m["value"]))
    return out


def main(argv=None) -> int:
    sets = [read_set(p) for p in (argv or sys.argv[1:])]
    for name in sorted(set().union(*sets)):
        per = [s[name] for s in sets if len(s.get(name, [])) >= 2]
        if not per:
            continue
        widest = max(spread(v) for v in per)
        print(json.dumps({
            "metric": name,
            "medians": [statistics.median(v) for v in per],
            "spreads": [spread(v) for v in per],
            "trimmed_spreads": [spread(trimmed(v)) for v in per
                                if len(v) >= 3],
            "all_runs_spread": spread([x for v in per for x in v]),
            "bound_5x": max(0.01, 5 * widest)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
