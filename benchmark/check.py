"""The comparison that decides ``correct``: the program's first three train
steps, as the window's own call drove them in set-up, against the plain
reference's three steps from the same inputs.

Three numbers, each with the limit the cell's file under
``benchmark/limits/`` gives it:

- ``loss_gap``: the largest relative gap of a step's loss,
  |L_program - L_reference| / |L_reference|, over the three steps;
- ``grad_gap``: the first gradient as Adam takes it (the weight decay
  joined), the program's worked out from Adam's first moment after one
  step (m1 = (1 - beta1) g): the worst leaf's gap of norms,
  | ||g_p|| - ||g_r|| |, over the larger of that leaf's reference norm and
  the median leaf's;
- ``change_gap``: the parameters' change after the three steps, as the
  fourth step finds them, by the same gap of norms, the median over the
  leaves (Adam turns a gradient element near zero into a step of about
  lr whose sign rounding decides, so the worst leaf swings from seed to
  seed with no fault: see PERF.md).

A leaf whose raw first gradient in the reference is under a thousandth of
the median leaf's moves by round-off alone and is left out of both gaps.
A number that is not finite fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

NAMES = ("loss_gap", "grad_gap", "change_gap")
DROP = 1e-3


class Steps(NamedTuple):
    """Three train steps: losses, the first gradient (weight decay joined),
    the parameters before and after, each leaf by name, and each step's
    NFE (printed beside the numbers, not compared)."""
    losses: List[float]
    first_grad: Dict[str, torch.Tensor]
    start: Dict[str, torch.Tensor]
    end: Dict[str, torch.Tensor]
    nfe: List[int]


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    med = float(np.median([ref[k] for k in keep]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in keep]


def numbers(prog: Steps, ref: Steps,
            ref_raw_grad: Dict[str, torch.Tensor]) -> Dict[str, float]:
    raw = _norms(ref_raw_grad)
    med = float(np.median(list(raw.values())))
    keep = [k for k in raw if raw[k] >= DROP * med]
    loss = max(abs(a - b) / max(abs(b), 1e-300)
               for a, b in zip(prog.losses, ref.losses))
    grad = max(_gaps(_norms(prog.first_grad), _norms(ref.first_grad), keep))

    def change(s: Steps):
        return _norms({k: s.end[k].double() - s.start[k].double()
                       for k in keep})

    chg = _gaps(change(prog), change(ref), keep)
    # the worst leaf's change is printed beside, not compared (docstring)
    out = {"loss_gap": loss, "grad_gap": grad,
           "change_gap": float(np.median(chg)), "change_gap_worst": max(chg)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(values[k] <= limits[k] for k in NAMES)
