"""A showcase record: the reference README's cora recipe (README.md:64)
through the port's dgnn driver, its test accuracy as a JSON file, as the
JAX repository's ``tools/record_showcase.py``.

The recipe (differential_gcn, hidden 256, dropout 0, T 1.2, tick 16,
weight decay 0.024, no control, dopri5, alpha 0, seed 0, fastmode) runs
``--iter`` models: as one batched program of independent replicas with
``--batch_iters``, else the reference's sequential loop with ``--dump``.
The record holds the JAX record's fields and ``card``, the card's name and
power limit (``nvidia-smi``). The default path is
``results_torch/showcase_<dataset>[_<iter> with --batch_iters].json``
(``results/`` holds the JAX package's TPU records).

Usage:
    python -m ndcn_tpu_torch.tools.record_showcase [--dataset cora]
        [--iter 5] [--epochs 100] [--batch_iters] [--platform cpu]
        [--out PATH]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

from ndcn_tpu_torch.tools import card, log

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REFERENCE_PUBLISHED = {
    # the reference's only published number (README.md:67-72)
    "cora": {"acc_mean": 0.83180, "acc_std": 0.00756, "acc_median": 0.830,
             "five_iter_wall_s": 772.385, "source": "README.md:67-72"},
}


def recipe(dataset: str, iters: int, epochs: int, batch_iters: bool,
           platform=None) -> list:
    """The dgnn driver's argv for the README.md:64 recipe on ``dataset``."""
    argv = ["--dataset", dataset, "--model", "differential_gcn",
            "--iter", str(iters), "--dropout", "0", "--hidden", "256",
            "--T", "1.2", "--time_tick", "16", "--epochs", str(epochs),
            "--weight_decay", "0.024", "--no_control", "--method", "dopri5",
            "--alpha", "0", "--seed", "0", "--fastmode"]
    argv += ["--batch_iters"] if batch_iters else ["--dump"]
    if platform:
        argv += ["--platform", platform]
    return argv


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("record_showcase")
    ap.add_argument("--dataset", default="cora",
                    choices=["cora", "citeseer", "pubmed"])
    ap.add_argument("--platform", default=None, choices=["gpu", "cpu"])
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--iter", type=int, default=5)
    ap.add_argument("--batch_iters", action="store_true",
                    help="train the models as one batched program of "
                         "independent replicas")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ndcn_tpu_torch.experiments import dgnn

    argv_d = recipe(args.dataset, args.iter, args.epochs, args.batch_iters,
                    args.platform)
    summary = dgnn.main(argv_d)
    on_card = args.platform != "cpu"
    out = {
        "experiment": f"reference README.md:64 recipe on {args.dataset}: "
                      f"differential_gcn, {args.iter} "
                      + ("independent batched replicas" if args.batch_iters
                         else "sequential iters"),
        "recipe": argv_d,
        "reference_published": REFERENCE_PUBLISHED.get(
            args.dataset,
            {"note": "no in-repo reference number for this dataset "
                     "(README.md publishes cora only)"}),
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "n_models": args.iter,
        "per_iter_acc": [row[2] for row in summary["rows"]],
        "acc_mean": summary.get("acc_mean"),
        "acc_std": summary.get("acc_std"),
        "acc_median": summary.get("acc_median"),
        "acc_min": summary.get("acc_min"), "acc_max": summary.get("acc_max"),
        "total_time_s": summary["total_time"],
        "device": summary.get("device"),
        "card": card() if on_card else None,
    }
    default_name = (f"showcase_{args.dataset}_{args.iter}.json"
                    if args.batch_iters else f"showcase_{args.dataset}.json")
    path = args.out or os.path.join(REPO, "results_torch", default_name)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f, indent=2)
    os.replace(tmp, path)
    print(json.dumps(out, indent=2))
    log(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
