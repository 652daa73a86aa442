"""Results-dict artifacts: dump / load / aggregate, as
``ndcn_tpu/report/results.py``.

The reference's artifact schema (heat_dynamics.py:297-311, 390-438): keys
'args', 'v_iter', 'abs_error', 'rel_error', 'true_y', 'predict_y',
'abs_error2', 'rel_error2', 'predict_y2', 'model_state_dict',
'total_time', serialized as a pickle of numpy arrays and Python objects
only, never a tensor. ``model_state_dict`` holds each evaluation's weights
as the JAX package's parameter tree (``convert.model_to_jax``), so each
package reads the other's dumps.
"""

from __future__ import annotations

import glob
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ndcn_tpu_torch.convert import model_to_jax
from ndcn_tpu_torch.train.checkpoint import load_pickle


def new_results_dict(args: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "args": dict(args),
        "v_iter": [],
        "abs_error": [],
        "rel_error": [],
        "true_y": [],
        "predict_y": [],
        "abs_error2": [],
        "rel_error2": [],
        "predict_y2": [],
        "model_state_dict": [],
        "total_time": None,
    }


def as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def record_eval(results: Dict[str, Any], itr: int, abs_error: float,
                rel_error: float, predict_y, model: torch.nn.Module,
                abs_error2: Optional[float] = None,
                rel_error2: Optional[float] = None,
                predict_y2=None) -> None:
    """Append one evaluation: its errors, predictions (as numpy) and the
    model's weights as the JAX package's parameter tree."""
    results["v_iter"].append(int(itr))
    results["abs_error"].append(float(abs_error))
    results["rel_error"].append(float(rel_error))
    results["predict_y"].append(as_numpy(predict_y))
    results["model_state_dict"].append(model_to_jax(model))
    if abs_error2 is not None:
        results["abs_error2"].append(float(abs_error2))
        results["rel_error2"].append(float(rel_error2))
        results["predict_y2"].append(as_numpy(predict_y2))


def dump_results(results: Dict[str, Any], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(results, f)
    return path


def load_results(path: str) -> Dict[str, Any]:
    """A dump of either package (``train.checkpoint.load_pickle``: numpy
    arrays and plain containers only)."""
    return load_pickle(path)


def results_path(results_dir: str, baseline: str,
                 appendix: Optional[str] = None) -> str:
    appendix = appendix or time.strftime("%m%d-%H%M%S")
    return os.path.join(results_dir, f"result_{appendix}.{baseline}")


def summarize_directory(directory: str, suffix: str) -> Dict[str, Any]:
    """Aggregate final abs/rel errors across dump files
    (summarize_result.py:26-57): mean / std for extrapolation and, when
    present, interpolation errors."""
    abs_err: List[float] = []
    rel_err: List[float] = []
    abs_err2: List[float] = []
    rel_err2: List[float] = []
    for filename in sorted(glob.glob(os.path.join(directory, f"*.{suffix}"))):
        r = load_results(filename)
        if not r.get("abs_error"):
            # a run that never reached a test_freq boundary dumps empty eval
            # lists; skip it instead of failing the whole aggregation
            print(f"[summarize] skipping {filename}: no recorded evals")
            continue
        abs_err.append(r["abs_error"][-1])
        rel_err.append(r["rel_error"][-1])
        if r.get("abs_error2"):
            abs_err2.append(r["abs_error2"][-1])
            rel_err2.append(r["rel_error2"][-1])
    out: Dict[str, Any] = {
        "n_runs": len(abs_err),
        "abs_error_mean": float(np.mean(abs_err)) if abs_err else float("nan"),
        "abs_error_std": float(np.std(abs_err)) if abs_err else float("nan"),
        "rel_error_mean": float(np.mean(rel_err)) if rel_err else float("nan"),
        "rel_error_std": float(np.std(rel_err)) if rel_err else float("nan"),
    }
    if abs_err2:
        out.update({
            "abs_error2_mean": float(np.mean(abs_err2)),
            "abs_error2_std": float(np.std(abs_err2)),
            "rel_error2_mean": float(np.mean(rel_err2)),
            "rel_error2_std": float(np.std(rel_err2)),
        })
    return out


def print_summary(summary: Dict[str, Any]) -> None:
    print("abs_error:")
    print("{} \\pm {}".format(summary["abs_error_mean"],
                              summary["abs_error_std"]))
    print("rel_error:")
    print("{:.1f} \\pm {:.1f} %".format(summary["rel_error_mean"] * 100,
                                        summary["rel_error_std"] * 100))
    if "abs_error2_mean" in summary:
        print("abs_error2 interpolation:")
        print("{} \\pm {}".format(summary["abs_error2_mean"],
                                  summary["abs_error2_std"]))
        print("rel_error2 interpolation:")
        print("{:.1f} \\pm {:.1f} %".format(summary["rel_error2_mean"] * 100,
                                            summary["rel_error2_std"] * 100))
