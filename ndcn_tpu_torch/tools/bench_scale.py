"""A scale record: the scale driver's estimate and a measured run in one
JSON file, as the JAX repository's ``tools/bench_scale.py``.

Runs ``python -m ndcn_tpu_torch.experiments.large_graph``, each run in a
process of its own: once with ``--estimate`` (the port's byte census of
the train step, ``experiments/large_graph.py``'s docstring) and
``--repeats`` times (3) for the measured run, and writes one record,
``{measured, estimate, argv, wall_s, card, runs_steps_per_sec}``,
atomically (a temporary file, then ``os.replace``). ``measured`` and
``wall_s`` are those of the run with the median steps/s, and
``runs_steps_per_sec`` holds every run's, in order: host-clock steps at
200k spread by tens of percent from one process to the next (PERF.md §5),
so one run is no baseline for ``tools.check_scale_records``. ``card`` is
the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` gives them.

The JAX tool runs its estimate on the CPU backend because its census is
derived from shapes. The port's census counts the tape on the CPU by
itself (``tape_bytes_per_node_attempt``) but resolves the solve's layout
and the card's memory from the run's device: on the CPU the 1M run's
'auto' would resolve to the (n, d) layout and ``fits`` to null. So the
estimate runs on the measured run's platform.

The default path is ``results_torch/scale_{n // 1000}k_{dynamics}.json``
(``results/`` holds the JAX package's TPU records). Every flag after the
tool's own passes through to the driver (``--gt_cache``,
``--emission_precision bf16``, ``--iters 40``, ``--mesh``, ...). A plain
process is a world of one rank, so a ``--mesh`` record's
``mesh_devices`` is 1: the sharded program on a one-rank group.

Usage:
    python -m ndcn_tpu_torch.tools.bench_scale --n 200000 --dynamics heat \\
        [--out results_torch/scale_200k_heat.json] [--repeats 3] \\
        [large_graph flags...]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ndcn_tpu_torch.tools import card, log

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DRIVER = "ndcn_tpu_torch.experiments.large_graph"


def run_demo(argv, timeout_s: int) -> dict:
    """Run the scale driver with ``argv`` in a process of its own; its last
    JSON line on stdout."""
    cmd = [sys.executable, "-m", DRIVER] + list(argv)
    log(f"[bench_scale] + {' '.join(cmd)}")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                       cwd=REPO)
    sys.stderr.write(r.stderr)
    if r.returncode != 0:
        raise SystemExit(f"{DRIVER} failed (rc {r.returncode}); stdout tail: "
                         f"{r.stdout[-500:]}; stderr tail: {r.stderr[-1500:]}")
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def platform_of(argv) -> str:
    """The driver's ``--platform`` in ``argv`` (its default: gpu)."""
    for i, a in enumerate(argv):
        if a == "--platform" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--platform="):
            return a.split("=", 1)[1]
    return "gpu"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("bench_scale")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--dynamics", type=str, default="heat")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--timeout", type=int, default=3600,
                    help="each process's wall-clock bound in seconds")
    ap.add_argument("--skip_estimate", action="store_true")
    ap.add_argument("--repeats", type=int, default=3,
                    help="measured runs; the record keeps the median's")
    args, passthrough = ap.parse_known_args(argv)

    base = ["--n", str(args.n), "--dynamics", args.dynamics] + passthrough
    if platform_of(base) != "cpu":
        from ndcn_tpu_torch.tools import require_cuda

        require_cuda()
    est = None
    if not args.skip_estimate:
        est = run_demo(base + ["--estimate"], args.timeout)
        log(f"[bench_scale] estimate: {est['estimate_gb']} GB "
            f"(fits={est['fits']}, layout={est['layout']})")

    runs = []
    for _ in range(max(1, args.repeats)):
        t0 = time.time()
        runs.append((run_demo(base, args.timeout), time.time() - t0))
    steps = [m["train_steps_per_sec"] for m, _ in runs]
    measured, wall = runs[sorted(range(len(runs)),
                                 key=steps.__getitem__)[len(runs) // 2]]
    record = {
        "measured": measured,
        "estimate": est,
        "argv": base,
        "wall_s": round(wall, 1),
        "card": card() if platform_of(base) != "cpu" else None,
        "runs_steps_per_sec": steps,
    }
    out = args.out or os.path.join(
        REPO, "results_torch", f"scale_{args.n // 1000}k_{args.dynamics}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
    os.replace(tmp, out)
    log(f"[bench_scale] wrote {out}")
    summary = {"out": out,
               "train_steps_per_sec": measured["train_steps_per_sec"],
               "runs_steps_per_sec": steps,
               "rel_loss_final": measured["rel_loss_final"],
               "device": measured["device"], "card": record["card"],
               "mesh_devices": measured.get("mesh_devices"),
               "hbm_peak_gb": measured.get("hbm_peak_gb"),
               "estimate_gb": est["estimate_gb"] if est else None}
    print(json.dumps(summary))
    return record


if __name__ == "__main__":
    main()
