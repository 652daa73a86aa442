"""Plots of a run, a copy of ``ndcn_tpu/report/viz.py`` (numpy in, PNG
out; matplotlib is imported at the first plot, not with the module).

The reference's 3-D surface plots and adjacency heatmaps
(utils_in_learn_dynamics.py:20-77), the error-curve replot after dumping
(heat_dynamics.py:440-451), and an animation writer in place of
image_to_gif.py. Without matplotlib every function prints that it skips
and returns.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None (printed) without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        print(f"[viz] matplotlib unavailable ({e}); skipping plots")
        return None


def surface(side: int, xt: np.ndarray, figname: str, title: str, outdir: str,
            zmin: Optional[float] = None, zmax: Optional[float] = None) -> None:
    """3-D surface of one snapshot on the side×side grid layout."""
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(outdir, exist_ok=True)
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401

    flat = np.asarray(xt).reshape(-1)
    padded = np.zeros(side * side, flat.dtype)
    padded[: min(flat.size, side * side)] = flat[: side * side]
    grid = padded.reshape(side, side)
    zmin = float(grid.min()) if zmin is None else zmin
    zmax = float(grid.max()) if zmax is None else zmax
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    ax.plot_surface(xs, ys, grid, cmap="rainbow", linewidth=0, antialiased=False,
                    vmin=zmin, vmax=zmax)
    ax.set_zlim(zmin, zmax)
    ax.set_title(title)
    fig.savefig(os.path.join(outdir, figname + ".png"), transparent=True)
    plt.close(fig)


def adjacency_heatmap(adj: np.ndarray, title: str, outdir: str = "figure/network") -> None:
    plt = pyplot()
    if plt is None:
        return
    os.makedirs(outdir, exist_ok=True)
    fig = plt.figure()
    plt.imshow(np.asarray(adj), cmap="Greys")
    fig.savefig(os.path.join(outdir, title + ".png"), transparent=True)
    plt.close(fig)


def error_curves(v_iter, abs_error, rel_error, path: str) -> None:
    """Error-vs-iteration plot saved beside a results dump."""
    plt = pyplot()
    if plt is None:
        return
    fig, ax = plt.subplots()
    ax.plot(v_iter, abs_error, "-", label="Absolute Error")
    ax.plot(v_iter, rel_error, "--", label="Relative Error")
    ax.legend(fontsize="x-large")
    fig.savefig(path + ".png", transparent=True)
    plt.close(fig)


def dynamics_surfaces(dynamics_kind: str, network: str, side: int,
                      true_y: np.ndarray, pred_test: np.ndarray) -> None:
    """Dump a handful of truth/prediction surfaces like the driver's --viz loop."""
    outdir = f"figure/{dynamics_kind}/{network}"
    zmin, zmax = float(true_y.min()), float(true_y.max())
    n_frames = true_y.shape[1]
    for i in range(0, n_frames, max(1, n_frames // 10)):
        surface(side, true_y[:, i], f"{i:03d}-tru", dynamics_kind, outdir, zmin, zmax)
    for i in range(0, pred_test.shape[1], max(1, pred_test.shape[1] // 5)):
        surface(side, pred_test[:, i], f"{i:03d}-pred", dynamics_kind, outdir,
                zmin, zmax)


def frames_to_animation(frame_dir: str, pattern: str, out_path: str,
                        fps: int = 8) -> None:
    """Assemble numbered PNG frames into an animated GIF (replaces image_to_gif.py)."""
    plt = pyplot()
    if plt is None:
        return
    import glob

    from matplotlib import animation, image as mpimg

    files = sorted(glob.glob(os.path.join(frame_dir, pattern)))
    if not files:
        print(f"[viz] no frames matching {pattern} under {frame_dir}")
        return
    fig = plt.figure()
    ax = fig.add_subplot()
    ax.axis("off")
    shown = ax.imshow(mpimg.imread(files[0]))

    def update(i):
        shown.set_data(mpimg.imread(files[i]))
        return (shown,)

    anim = animation.FuncAnimation(fig, update, frames=len(files), blit=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
