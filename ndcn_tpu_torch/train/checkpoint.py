"""Periodic checkpoint / resume, as ``ndcn_tpu/train/checkpoint.py``.

Atomically written, step-stamped snapshots ``ckpt_{step:08d}.pkl`` with
latest-k retention and a one-call resume. The payload is the JAX package's:
a pickle of {"step", "params", "opt_state", "extra"}, every array a numpy
array:

- ``params`` is the JAX package's parameter tree (``convert.model_to_jax``:
  NDCN's layer dict, or a zoo model's nested tree), so a checkpoint
  written by either package loads its weights into the other;
- ``opt_state`` is ``torch.optim.Adam``'s ``state_dict`` with its tensors
  as numpy arrays (a JAX-written checkpoint's optax state is not read: the
  optimizer then starts afresh);
- ``extra`` holds what a driver needs to repeat the interrupted run exactly
  (the dynamics drivers keep their dropout generator's state there).

Checkpoints are read with an unpickler that builds numpy arrays and plain
containers only: a class of another package (the JAX package's optimizer
state) becomes an inert placeholder, and nothing is imported for it.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ndcn_tpu_torch.convert import model_from_jax, model_to_jax
from ndcn_tpu_torch.utils.io import atomic_write

_CKPT_RE = re.compile(r"ckpt_(\d+)\.pkl$")
_SAFE_MODULES = ("builtins", "collections", "copyreg", "_codecs", "numpy")


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


def save_checkpoint(ckpt_dir: str, step: int, model,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Atomically write ckpt_{step}.pkl and prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "params": model_to_jax(model),
        "opt_state": (_to_numpy(optimizer.state_dict())
                      if optimizer is not None else None),
        "extra": _to_numpy(extra or {}),
    }
    path = os.path.join(ckpt_dir, f"ckpt_{int(step):08d}.pkl")
    atomic_write(path, pickle.dumps(payload))

    steps = sorted(all_checkpoint_steps(ckpt_dir))
    for old in steps[:-keep] if keep else []:
        os.unlink(os.path.join(ckpt_dir, f"ckpt_{old:08d}.pkl"))
    return path


def all_checkpoint_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return [int(m.group(1)) for name in os.listdir(ckpt_dir)
            if (m := _CKPT_RE.match(name))]


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = all_checkpoint_steps(ckpt_dir)
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"ckpt_{max(steps):08d}.pkl")


class _Foreign:
    """Stands in for an object of a class outside numpy and the builtins."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _SAFE_MODULES:
            return super().find_class(module, name)
        return _Foreign


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def restore_with_extra(ckpt_dir: Optional[str], model,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> Tuple[int, Dict[str, Any]]:
    """Resume from the newest checkpoint in ``ckpt_dir``, if there is one:
    its weights go into ``model`` and its optimizer state into ``optimizer``
    in place. Returns (step, extra), (0, {}) when there is nothing to
    resume."""
    if not ckpt_dir:
        return 0, {}
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return 0, {}
    payload = load_checkpoint(path)
    model_from_jax(payload["params"], model)
    opt_state = payload.get("opt_state")
    if optimizer is not None and isinstance(opt_state, dict) \
            and set(opt_state) == {"state", "param_groups"}:
        optimizer.load_state_dict(_to_torch(opt_state))
    elif optimizer is not None and opt_state is not None:
        print(f"[checkpoint] {path} holds another optimizer's state; the "
              f"optimizer starts afresh")
    print(f"[checkpoint] resumed from {path} (step {payload['step']})")
    return payload["step"], _to_torch(payload.get("extra", {}))


def restore_or_init(ckpt_dir: Optional[str], model,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """``restore_with_extra`` without the extra: the step to resume at."""
    return restore_with_extra(ckpt_dir, model, optimizer)[0]
