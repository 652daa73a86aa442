"""Carry NDCN weights between the JAX package and the port.

The JAX package keeps a dict of layers ``{"enc1": {"w", "b"}, "enc2", "wt",
"dec"}`` with ``w`` stored (in, out); ``nn.Linear.weight`` is (out, in). The
arrays cross as numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

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
