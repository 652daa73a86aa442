"""T × alpha accuracy grid of the differential GCN, as
``ndcn_tpu/experiments/sweep_t_alpha.py`` (the reference's
plot_time_and_alpha.py, which scraped printed logs of manual runs).

Runs ``experiments.dgnn`` (``--model differential_gcn``) for every (T,
alpha) cell and writes the test accuracies as a CSV matrix in the JAX
package's format. Each finished cell is appended to ``<out_csv>.cells``
("T,alpha,acc,std"), so ``--resume`` restarts a cut sweep at the first
unfinished cell; without ``--resume`` that file is removed first.
``--heatmap``, ``--surface`` and ``--errorbar`` draw the grid
(matplotlib imported at the first figure; without it, a skip). A cell of
several replicas (``--batch_iters --iter R``) trains them at once through
the dgnn driver's sweep and records their mean accuracy and its standard
deviation, as the JAX sweep does.

Usage:
    python -m ndcn_tpu_torch.experiments.sweep_t_alpha --dataset cora \
        --T_values 0.6 1.2 1.8 --alpha_values 0 0.5 1.0 --epochs 50
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    from ndcn_tpu_torch.experiments.dgnn import build_parser as dgnn_parser
    p = dgnn_parser()
    p.add_argument("--T_values", type=float, nargs="+",
                   default=[0.6, 0.9, 1.2, 1.5, 1.8])
    p.add_argument("--alpha_values", type=float, nargs="+",
                   default=[0.0, 0.25, 0.5, 0.75, 1.0])
    p.add_argument("--out_csv", type=str, default="results/t_alpha_grid.csv")
    p.add_argument("--resume", action="store_true",
                   help="skip (T, alpha) cells already in the cell log "
                        "(<out_csv>.cells)")
    p.add_argument("--heatmap", action="store_true")
    p.add_argument("--surface", action="store_true",
                   help="3-D accuracy surface over the T x alpha grid "
                        "(reference plot_time_and_alpha.py:90-143)")
    p.add_argument("--errorbar", action="store_true",
                   help="2-D accuracy-vs-T errorbar curve at one alpha "
                        "(reference plot_time_and_alpha.py:146-172)")
    p.add_argument("--errorbar_alpha", type=float, default=None,
                   help="alpha column for --errorbar (default: the column "
                        "with the best mean accuracy)")
    return p


def read_cells(cells_path: str) -> dict:
    """{(T, alpha): (acc, std)} of the cell log's complete lines."""
    done = {}
    with open(cells_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) == 4:
                t_v, a_v, acc, std = (float(x) for x in parts)
                done[(t_v, a_v)] = (acc, std)
    return done


def grid_csv(t_values, alpha_values, grid: np.ndarray) -> str:
    """The CSV text: a header of alphas, a row per T, 4 decimals."""
    header = "T\\alpha," + ",".join(str(a) for a in alpha_values)
    rows = [f"{t}," + ",".join(f"{v:.4f}" for v in grid[i])
            for i, t in enumerate(t_values)]
    return header + "\n" + "\n".join(rows) + "\n"


def main(argv=None):
    from ndcn_tpu_torch.experiments import dgnn
    from ndcn_tpu_torch.experiments.dynamics import select_device

    args, _ = build_parser().parse_known_args(argv)
    args.model = "differential_gcn"
    select_device(args.platform)   # no card for --platform gpu: raise now

    grid = np.zeros((len(args.T_values), len(args.alpha_values)))
    grid_std = np.zeros_like(grid)  # 0 for single-replica cells

    cells_path = args.out_csv + ".cells"
    os.makedirs(os.path.dirname(args.out_csv) or ".", exist_ok=True)
    done: dict = {}
    if args.resume and os.path.exists(cells_path):
        done = read_cells(cells_path)
        print(f"[sweep] resume: {len(done)} cells already in {cells_path}",
              flush=True)
    elif os.path.exists(cells_path):
        os.remove(cells_path)

    for i, t_val in enumerate(args.T_values):
        for j, alpha in enumerate(args.alpha_values):
            key = (float(t_val), float(alpha))
            if key in done:
                grid[i, j], grid_std[i, j] = done[key]
                print(f"[sweep] T={t_val} alpha={alpha} "
                      f"acc={grid[i, j]:.4f} (resumed)", flush=True)
                continue
            cell_args = copy.deepcopy(args)
            cell_args.T = float(t_val)
            cell_args.alpha = float(alpha)
            cell_args.dump = False
            out = dgnn.run(cell_args)
            # a multi-replica run reports the mean accuracy; rows[-1][2]
            # would be one replica's
            grid[i, j] = out.get("acc_mean") or out["rows"][-1][2]
            grid_std[i, j] = out.get("acc_std") or 0.0
            with open(cells_path, "a") as f:
                f.write(f"{t_val},{alpha},{grid[i, j]:.6f},"
                        f"{grid_std[i, j]:.6f}\n")
            print(f"[sweep] T={t_val} alpha={alpha} acc={grid[i, j]:.4f}",
                  flush=True)

    with open(args.out_csv, "w") as f:
        f.write(grid_csv(args.T_values, args.alpha_values, grid))
    print(f"[sweep] wrote {args.out_csv}")
    if args.heatmap or args.surface or args.errorbar:
        _figures(args, grid, grid_std)
    return grid


def _figures(args, grid: np.ndarray, grid_std: np.ndarray) -> None:
    from ndcn_tpu_torch.report.viz import pyplot

    plt = pyplot()
    if plt is None:
        return
    if args.heatmap:
        fig, ax = plt.subplots()
        im = ax.imshow(grid, cmap="viridis", aspect="auto")
        ax.set_xticks(range(len(args.alpha_values)),
                      [str(a) for a in args.alpha_values])
        ax.set_yticks(range(len(args.T_values)),
                      [str(t) for t in args.T_values])
        ax.set_xlabel("alpha")
        ax.set_ylabel("T")
        fig.colorbar(im)
        path = args.out_csv.replace(".csv", ".png")
        fig.savefig(path)
        plt.close(fig)
        print(f"[sweep] wrote {path}")
    if args.surface:
        # the reference's plot_acc_time_alpha_3d (plot_time_and_alpha.py
        # :90-143), drawn from the sweep in memory
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        alpha_m, t_m = np.meshgrid(args.alpha_values, args.T_values)
        surf = ax.plot_surface(alpha_m, t_m, grid, cmap="rainbow",
                               linewidth=0, antialiased=False)
        fig.colorbar(surf, shrink=0.5, aspect=5)
        ax.set_xlabel("Alpha")
        ax.set_ylabel("Terminal Time")
        ax.set_zlabel("Accuracy")
        path = args.out_csv.replace(".csv", "_3d.png")
        fig.savefig(path)
        plt.close(fig)
        print(f"[sweep] wrote {path}")
    if args.errorbar:
        # accuracy vs T at one alpha with std error bars (the reference's
        # plot_acc_time_alpha_2d, plot_time_and_alpha.py:146-172, which
        # hardcodes each dataset's best column; here the best mean)
        if args.errorbar_alpha is not None:
            j = int(np.argmin(np.abs(np.asarray(args.alpha_values)
                                     - args.errorbar_alpha)))
        else:
            j = int(np.argmax(grid.mean(axis=0)))
        fig, ax = plt.subplots()
        ax.errorbar(args.T_values, grid[:, j], yerr=grid_std[:, j],
                    fmt="-sk", linewidth=2, markersize=10)
        ax.set_xlabel("Terminal Time", fontsize=14)
        ax.set_ylabel("Accuracy", fontsize=14)
        ax.set_title(f"{args.dataset} (alpha={args.alpha_values[j]})")
        path = args.out_csv.replace(".csv", "_errorbar.png")
        fig.savefig(path)
        plt.close(fig)
        print(f"[sweep] wrote {path}")


if __name__ == "__main__":
    main()
