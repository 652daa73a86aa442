"""The gate on the port's committed scale records, as the JAX repository's
``tools/check_scale_records.py``.

For each record (``results_torch/scale_*.json``, written by
``tools.bench_scale``) the record's own argv runs again through the scale
driver, cut to ``--iters 20`` and without the probes (``--roofline``,
``--hbm_probe``: they do not move steps/s), and the tool exits 1 when the
measured ``train_steps_per_sec`` is more than ``--tol`` (10 %) under the
record's (the median of the runs ``tools.bench_scale`` made). Faster
never fails; it prints advice to record again. A ``--gt_cache`` path in
the argv is moved under the checkout's ``build/gt_cache/``, so a rerun
reads no truth that other code wrote, and it is written by the driver when
it is absent: the first check of a record also solves its ground truth.

Each record gives one JSON line: the record's card beside this run's
(``nvidia-smi``'s name and power limit). A record taken on another card is
compared all the same, as in the JAX tool, and the line says the cards
differ. Host-clock steps at 200k spread by tens of percent from call to
call (PERF.md §5), so one reading that fails is a reason to run it again
before it is a regression.

It measures the card, and refuses without one unless given ``--platform
cpu`` (the runs then take the plain versions on the CPU).

Usage (on the card):
    python -m ndcn_tpu_torch.tools.check_scale_records
    python -m ndcn_tpu_torch.tools.check_scale_records \\
        --records results_torch/scale_200k_heat.json --iters 40
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from ndcn_tpu_torch.tools import card, log, require_cuda

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DRIVER = "ndcn_tpu_torch.experiments.large_graph"

DEFAULT_RECORDS = ["results_torch/scale_200k_heat.json",
                   "results_torch/scale_200k_heat_mesh.json"]


def strip_flag(argv, flag, has_value=True):
    out, i = [], 0
    while i < len(argv):
        if argv[i] == flag:
            i += 2 if has_value else 1
            continue
        out.append(argv[i])
        i += 1
    return out


def local_gt_cache(argv):
    """``argv`` with its ``--gt_cache`` path under this checkout's
    ``build/gt_cache/`` (the file's name kept)."""
    out = list(argv)
    for i in range(len(out) - 1):
        if out[i] == "--gt_cache":
            out[i + 1] = os.path.join(REPO, "build", "gt_cache",
                                      os.path.basename(out[i + 1]))
    return out


def rerun(argv, iters, timeout_s):
    cmd = [sys.executable, "-m", DRIVER] + list(argv) + ["--iters",
                                                         str(iters)]
    log(f"[check] + {' '.join(cmd)}")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s,
                       cwd=REPO)
    sys.stderr.write(r.stderr)
    if r.returncode != 0:
        raise SystemExit(f"re-run failed (rc {r.returncode}); stdout tail: "
                         f"{r.stdout[-500:]}")
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser("check_scale_records")
    ap.add_argument("--records", nargs="+", default=DEFAULT_RECORDS)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed iterations of the run (the records take 60)")
    ap.add_argument("--tol", type=float, default=0.10,
                    help="allowed fractional slowdown against the record's "
                         "steps/s")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                    help="cpu: the runs on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    if args.platform == "gpu":
        require_cuda()

    this_card = card() if args.platform == "gpu" else None
    failures, lines = [], []
    for path in args.records:
        with open(os.path.join(REPO, path)) as f:
            rec = json.load(f)
        measured = rec.get("measured", rec)
        committed = float(measured["train_steps_per_sec"])
        rec_argv = rec["argv"]
        rec_argv = strip_flag(rec_argv, "--out")
        rec_argv = strip_flag(rec_argv, "--iters")
        rec_argv = strip_flag(rec_argv, "--hbm_probe", has_value=False)
        rec_argv = strip_flag(rec_argv, "--roofline", has_value=False)
        rec_argv = local_gt_cache(rec_argv)
        if args.platform == "cpu":
            rec_argv = strip_flag(rec_argv, "--platform") + ["--platform",
                                                             "cpu"]
        fresh = rerun(rec_argv, args.iters, args.timeout)
        now = float(fresh["train_steps_per_sec"])
        ratio = now / committed
        status = "OK" if ratio >= 1.0 - args.tol else "REGRESSION"
        if status == "REGRESSION":
            failures.append(path)
        note = ("consider re-recording (faster than the record)"
                if ratio > 1.0 + args.tol else "")
        line = {"record": path, "committed_steps_per_s": committed,
                "record_runs_steps_per_s": rec.get("runs_steps_per_sec"),
                "measured_steps_per_s": now, "ratio": round(ratio, 3),
                "status": status, "note": note,
                "device": fresh.get("device"),
                "record_card": rec.get("card"), "card": this_card,
                "cards_differ": rec.get("card") != this_card}
        print(json.dumps(line))
        lines.append(line)
    if failures:
        raise SystemExit(f"scale regression vs committed record(s): "
                         f"{failures} (tol {args.tol:.0%})")
    return lines


if __name__ == "__main__":
    main()
