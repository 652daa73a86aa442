"""Losses of the dynamics tasks, as ``ndcn_tpu/train/losses.py`` (the
reference's definitions, which define the benchmark numbers): abs error =
mean |pred - true| (l1), rel error = l1 / mean(true)."""

from __future__ import annotations

import torch


def l1_loss(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true))


def relative_l1(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return l1_loss(pred, true) / torch.mean(true)
