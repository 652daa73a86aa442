"""Observation-time sampling for the dynamics tasks, and the trajectory
windows of the Lotka-Volterra demo (host side, numpy).

Copied from the jax-free ``ndcn_tpu/train/sampling.py``: the same seed gives
the same grid, which is what a frozen server's time axis is built from, and
the same windows.

- equal:     t = linspace(0, T, tick); first 80% train, last 20% extrapolation.
- irregular: 10x-oversampled linspace, keep a random 1.2*tick subset (sorted,
  t[0]=0); indices >= tick are extrapolation (id_test), a random 20% of
  (0, tick) are interpolation (id_test2), the rest train.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class TimeSplits(NamedTuple):
    t: np.ndarray            # full observation grid, float32, t[0] = 0
    id_train: np.ndarray     # int indices into t
    id_test: np.ndarray      # extrapolation indices
    id_test2: Optional[np.ndarray]  # interpolation indices (irregular only)


def sample_times(total_time: float, time_tick: int, sampled: str = "irregular",
                 seed: Optional[int] = None, sparse_scale: int = 10) -> TimeSplits:
    if sampled == "equal":
        t = np.linspace(0.0, total_time, time_tick).astype(np.float32)
        split = int(time_tick * 0.8)
        return TimeSplits(t=t,
                          id_train=np.arange(split),
                          id_test=np.arange(split, time_tick),
                          id_test2=None)
    if sampled != "irregular":
        raise ValueError(f"unknown sampling {sampled!r}")

    rng = np.random.RandomState(seed)
    dense = np.linspace(0.0, total_time, time_tick * sparse_scale)
    picked = rng.permutation(dense)[: int(time_tick * 1.2)]
    t = np.sort(picked).astype(np.float32)
    t[0] = 0.0

    id_test = np.arange(time_tick, int(time_tick * 1.2))
    id_test2 = np.sort(rng.permutation(np.arange(1, time_tick))[: int(time_tick * 0.2)])
    id_train = np.array(sorted(set(range(time_tick)) - set(id_test2.tolist())))
    return TimeSplits(t=t, id_train=id_train, id_test=id_test, id_test2=id_test2)


def sample_trajectory_windows(rng, trajectory, batch_time: int,
                              batch_size: int):
    """Random minibatch of trajectory windows (the reference's ``get_batch``,
    utils_in_learn_dynamics.py:181-198), as the JAX package's: pick
    ``batch_size`` start indices and return (y0 (B, ...), window
    (batch_time, B, ...)) of the following samples.

    ``rng`` is a np.random.RandomState; ``trajectory`` (numpy) has time on
    axis 0."""
    data_size = trajectory.shape[0]
    starts = rng.choice(data_size - batch_time, batch_size, replace=False)
    y0 = trajectory[starts]
    window = np.stack([trajectory[starts + i] for i in range(batch_time)])
    return y0, window
