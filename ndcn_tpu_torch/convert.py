"""Carry weights between the JAX package and the port.

NDCN: the JAX package keeps a dict of layers ``{"enc1": {"w", "b"}, "enc2",
"wt", "dec"}`` with ``w`` stored (in, out); ``nn.Linear.weight`` is (out,
in). The GCN zoo: nested dicts with lists (``middle``, ``diag``,
``blocks``), linears as above, ``DiagLinear`` as ``{"weight", "bias"}``, and
plain arrays (a (1,) ``time_step``, ``time_step_list``, ``AW``); each zoo
model's ``jax_tree`` names its parameters by those keys. The arrays cross as
numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from torch import nn

from ndcn_tpu_torch.models import gcn_zoo
from ndcn_tpu_torch.models.ndcn import NDCN

LAYERS = ("enc1", "enc2", "wt", "dec")


def params_from_jax(tree: Dict[str, Dict[str, np.ndarray]],
                    model: Optional[NDCN] = None,
                    device: Optional[torch.device] = None) -> NDCN:
    """Load a JAX parameter dict into ``model`` (built to its shapes when
    None) and return the model. The two must have the same layers."""
    if model is None:
        w_dec = np.asarray(tree["dec"]["w"])
        no_embed = "enc1" not in tree
        in_size = w_dec.shape[0] if no_embed else np.shape(tree["enc1"]["w"])[0]
        model = NDCN(in_size, w_dec.shape[0], w_dec.shape[1],
                     generator=torch.Generator().manual_seed(0),
                     no_embed=no_embed, no_control="wt" not in tree,
                     encoder_layers=2 if "enc2" in tree else 1)
    present = {name for name in LAYERS if getattr(model, name) is not None}
    if present != set(tree):
        raise ValueError(f"layer sets differ: JAX params have {sorted(tree)}, "
                         f"the model has {sorted(present)}")
    with torch.no_grad():
        for name in present:
            layer = getattr(model, name)
            w = torch.tensor(np.asarray(tree[name]["w"]), dtype=torch.float32)
            if w.T.shape != layer.weight.shape:
                raise ValueError(f"{name}: JAX w {tuple(w.shape)} does not fit "
                                 f"weight {tuple(layer.weight.shape)}")
            layer.weight.copy_(w.T)
            if ("b" in tree[name]) != (layer.bias is not None):
                raise ValueError(f"{name}: bias present on one side only")
            if layer.bias is not None:
                layer.bias.copy_(torch.tensor(np.asarray(tree[name]["b"])))
    return model.to(device) if device is not None else model


def params_to_jax(model: NDCN) -> Dict[str, Dict[str, np.ndarray]]:
    """The model's weights as the JAX package's parameter dict (numpy)."""
    tree = {}
    for name in LAYERS:
        layer = getattr(model, name)
        if layer is None:
            continue
        tree[name] = {"w": layer.weight.detach().cpu().numpy().T.copy()}
        if layer.bias is not None:
            tree[name]["b"] = layer.bias.detach().cpu().numpy().copy()
    return tree


def _fill(name: str, ref, value) -> None:
    """Copy the JAX subtree ``value`` into ``ref``, one node of a zoo
    model's ``jax_tree``, checking that the two have the same structure."""
    if isinstance(ref, nn.Linear):
        w = torch.tensor(np.asarray(value["w"]), dtype=torch.float32)
        if w.T.shape != ref.weight.shape or ("b" in value) != (
                ref.bias is not None) or set(value) - {"w", "b"}:
            raise ValueError(f"{name}: JAX linear {sorted(value)} w "
                             f"{tuple(w.shape)} does not fit weight "
                             f"{tuple(ref.weight.shape)}")
        ref.weight.copy_(w.T)
        if ref.bias is not None:
            ref.bias.copy_(torch.tensor(np.asarray(value["b"])))
    elif isinstance(ref, gcn_zoo.DiagLinear):
        if set(value) != ({"weight", "bias"} if ref.bias is not None
                          else {"weight"}):
            raise ValueError(f"{name}: JAX DiagLinear has {sorted(value)}")
        _fill(f"{name}.weight", ref.weight, value["weight"])
        if ref.bias is not None:
            _fill(f"{name}.bias", ref.bias, value["bias"])
    elif isinstance(ref, torch.Tensor):
        arr = torch.tensor(np.asarray(value), dtype=torch.float32)
        if arr.shape != ref.shape:
            raise ValueError(f"{name}: JAX array {tuple(arr.shape)} does not "
                             f"fit {tuple(ref.shape)}")
        ref.copy_(arr)
    elif isinstance(ref, dict):
        if not isinstance(value, dict) or set(value) != set(ref):
            raise ValueError(f"{name}: JAX params have "
                             f"{sorted(value) if isinstance(value, dict) else type(value).__name__}"
                             f", the model has {sorted(ref)}")
        for key in ref:
            _fill(f"{name}.{key}" if name else key, ref[key], value[key])
    elif isinstance(ref, list):
        if not isinstance(value, (list, tuple)) or len(value) != len(ref):
            raise ValueError(f"{name}: JAX list of {len(value)}, the model "
                             f"has {len(ref)}")
        for i, (r, v) in enumerate(zip(ref, value)):
            _fill(f"{name}[{i}]", r, v)
    else:
        raise TypeError(f"{name}: no JAX form for {type(ref).__name__}")


def _export(ref) -> Any:
    if isinstance(ref, nn.Linear):
        out = {"w": ref.weight.detach().cpu().numpy().T.copy()}
        if ref.bias is not None:
            out["b"] = ref.bias.detach().cpu().numpy().copy()
        return out
    if isinstance(ref, gcn_zoo.DiagLinear):
        out = {"weight": _export(ref.weight)}
        if ref.bias is not None:
            out["bias"] = _export(ref.bias)
        return out
    if isinstance(ref, torch.Tensor):
        return ref.detach().cpu().numpy().copy()
    if isinstance(ref, dict):
        return {k: _export(v) for k, v in ref.items()}
    return [_export(v) for v in ref]


def _zoo_from_tree(name: str, tree) -> nn.Module:
    """A zoo model of ``name`` shaped like the JAX tree (weights drawn from
    a seed-0 generator, to be overwritten)."""
    g = torch.Generator().manual_seed(0)
    if name in ("GCN", "DeepGCN"):
        (h_in, hidden), classes = (np.shape(tree["gc1"]["w"]),
                                   np.shape(tree["gc2"]["w"])[1])
        cls = gcn_zoo.GCN if name == "GCN" else gcn_zoo.DeepGCN
        return cls(h_in, hidden, classes, len(tree["middle"]), generator=g)
    if name == "resGCN":
        (h_in, hidden), classes = (np.shape(tree["in"]["w"]),
                                   np.shape(tree["out"]["w"])[1])
        blocks = tree["blocks"]
        return gcn_zoo.ResGCN(
            h_in, hidden, classes, len(blocks),
            euler=bool(blocks) and "time_step" in blocks[0],
            time_varying=bool(blocks) and "linear" in blocks[0], generator=g)
    (h_in, hidden), classes = (np.shape(tree["linear1"]["w"]),
                               np.shape(tree["linear2"]["w"])[1])
    if name == "DeepGCN2":
        return gcn_zoo.DeepGCN2(h_in, hidden, classes, generator=g)
    if name == "DeepGCN3":
        return gcn_zoo.DeepGCN3(h_in, hidden, classes,
                                np.shape(tree["AW"])[0], generator=g)
    if name == "DeepGCN4":
        return gcn_zoo.DeepGCN4(h_in, hidden, classes, len(tree["diag"]),
                                generator=g)
    raise ValueError(f"unknown zoo model {name!r}; choose from "
                     f"{gcn_zoo.ZOO}")


def zoo_params_from_jax(name: Optional[str], tree,
                        model: Optional[nn.Module] = None,
                        device: Optional[torch.device] = None) -> nn.Module:
    """Load the JAX package's parameter tree of zoo model ``name`` into
    ``model`` (built to the tree's shapes when None; ``name`` is needed
    only then) and return the model.
    The two must have the same structure. DeepGCN3's ``num_middle_layers``
    is not in its tree: a model built here has none; pass the model to set
    it."""
    if model is None:
        model = _zoo_from_tree(name, tree)
    with torch.no_grad():
        _fill("", model.jax_tree(), tree)
    return model.to(device) if device is not None else model


def zoo_params_to_jax(model: nn.Module):
    """A zoo model's weights as the JAX package's parameter tree (numpy)."""
    return _export(model.jax_tree())


def model_to_jax(model: nn.Module):
    """The JAX parameter tree of an NDCN or a zoo model."""
    if isinstance(model, NDCN):
        return params_to_jax(model)
    return zoo_params_to_jax(model)


def model_from_jax(tree, model: nn.Module) -> nn.Module:
    """Load a JAX parameter tree into an NDCN or a zoo model, in place."""
    if isinstance(model, NDCN):
        return params_from_jax(tree, model)
    return zoo_params_from_jax(None, tree, model)
