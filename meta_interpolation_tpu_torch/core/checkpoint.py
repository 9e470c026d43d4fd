"""Weight bridge between JAX parameter trees, reference ``.pth`` files and
PyTorch state dicts.

Counterpart of ``meta_interpolation_tpu/core/checkpoint.py:95-171``. The
JAX trees mirror the torch module names (``tree['moduleConv1']['0']
['kernel']`` ↔ ``'moduleConv1.0.weight'``), so the bridge is a name join
plus the conv layout transpose HWIO ↔ OIHW; biases carry over as they
are. These are the only leaves of the ported models.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy leaves (a JAX parameter tree) → state dict."""
    state = {}
    for path, value in _flatten(tree):
        parent, _, leaf = path.rpartition(".")
        value = np.asarray(value)
        if leaf == "kernel":         # HWIO → OIHW
            value, leaf = value.transpose(3, 2, 0, 1), "weight"
        state[f"{parent}.{leaf}" if parent else leaf] = torch.tensor(value)
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """State dict → nested dict of numpy leaves shaped like the JAX tree
    (the inverse of :func:`params_from_jax`)."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        parts = name.split(".")
        value = value.detach().cpu().numpy()
        leaf = parts[-1]
        if leaf == "weight":         # OIHW → HWIO
            value, leaf = value.transpose(2, 3, 1, 0), "kernel"
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` (a state dict, or a dict holding one under
    ``'state_dict'``) → {name: tensor on the CPU}, ``module.`` stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k.replace("module.", ""): v.detach() for k, v in obj.items()
            if torch.is_tensor(v)}


def lossy_merge(target: Dict[str, torch.Tensor],
                loaded: Dict[str, torch.Tensor]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, bool]]:
    """Take each entry of ``loaded`` whose name and shape match ``target``;
    keep the rest of ``target`` (reference lossy_load_state_dict,
    utils.py:89-107). Returns (merged, {name: was loaded})."""
    merged, mask, skipped = {}, {}, []
    for name, value in target.items():
        lv = loaded.get(name)
        ok = lv is not None and tuple(lv.shape) == tuple(value.shape)
        mask[name] = ok
        merged[name] = lv.to(value.device, value.dtype) if ok else value
        if lv is not None and not ok:
            skipped.append(name)
    if skipped:
        print(f"[checkpoint] skipped {len(skipped)} mismatched keys: "
              f"{skipped[:5]}{'...' if len(skipped) > 5 else ''}")
    return merged, mask


def import_pth(path: str, target: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, bool]]:
    """Reference-named weights load directly: merge ``path`` into
    ``target`` (a state dict) by name and shape."""
    return lossy_merge(target, load_torch_file(path))
