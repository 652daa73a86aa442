"""Losses and metrics, as ``ndcn_tpu/train/losses.py`` (the reference's
definitions, which define the benchmark numbers):

- dynamics: abs error = mean |pred - true| (l1), rel error = l1 / mean(true);
- classification: softmax cross-entropy with mean reduction over the rows
  given, accuracy, and micro / macro F1.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - true))


def relative_l1(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    return l1_loss(pred, true) / torch.mean(true)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax CE, mean over rows. logits (m, C), labels (m,) int."""
    return F.cross_entropy(logits, labels.long())


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))


def f1_scores(logits, labels):
    """(micro, macro) F1 on host numpy (evaluation only)."""
    preds = torch.argmax(torch.as_tensor(logits), -1).cpu().numpy()
    labels = torch.as_tensor(labels).cpu().numpy()
    classes = np.unique(np.concatenate([labels, preds]))
    tp_all = fp_all = fn_all = 0.0
    per_class_f1 = []
    for c in classes:
        tp = float(np.sum((preds == c) & (labels == c)))
        fp = float(np.sum((preds == c) & (labels != c)))
        fn = float(np.sum((preds != c) & (labels == c)))
        tp_all, fp_all, fn_all = tp_all + tp, fp_all + fp, fn_all + fn
        denom = 2 * tp + fp + fn
        per_class_f1.append(2 * tp / denom if denom > 0 else 0.0)
    micro_denom = 2 * tp_all + fp_all + fn_all
    micro = 2 * tp_all / micro_denom if micro_denom > 0 else 0.0
    return micro, float(np.mean(per_class_f1))
