"""Checkpoints of the port, and the weight bridge between JAX parameter
trees, reference ``.pth`` files and PyTorch state dicts.

:func:`save_checkpoint` / :func:`load_checkpoint` keep a run's state as
``torch.save`` of ``{epoch, arch, system, best_PSNR}`` in
``checkpoint_dir/exp_name/checkpoint.pth`` (and ``model_best.pth``), the
reference's file names (``utils.py:34-60``). The JAX package's
``checkpoint.pkl`` pickles optax state objects and is not read here.

Counterpart of ``meta_interpolation_tpu/core/checkpoint.py:95-171``. The
JAX trees mirror the torch module names (``tree['moduleConv1']['0']
['kernel']`` ↔ ``'moduleConv1.0.weight'``), so the bridge is a name join
plus a layout rule per leaf kind:

  * conv ``kernel`` HWIO ↔ ``nn.Conv2d.weight`` OIHW;
  * transposed-conv ``kernel`` (kh, kw, in, out) ↔ ``nn.ConvTranspose2d.
    weight`` (in, out, kh, kw). The JAX tree cannot tell the two kinds
    apart, and a square 2→2 transposed conv (DAIN's ``deconv*``) loads
    silently wrong under the conv rule, so the rule is keyed on the module
    type: every call names the model whose state dict is meant;
  * batch norm ``mean``/``var`` ↔ the ``running_mean``/``running_var``
    buffers, ``scale`` ↔ ``weight`` (affine only);
  * ``bias`` as it is.

The VGG16 weights of SuperSloMo's ``Super`` loss, which are the loss's and
not the model's, bridge with :func:`vgg16_params_from_jax`.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

# a run's state, and its copy when the run is the best so far (reference
# utils.py:34-60)
CHECKPOINT, BEST = "checkpoint.pth", "model_best.pth"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(state: Dict[str, Any], directory: str,
                    is_best: bool = False):
    """``torch.save`` of ``state`` with its tensors on the CPU to
    ``directory/checkpoint.pth``, copied to ``model_best.pth`` when the run
    is the best so far."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, CHECKPOINT)
    torch.save(_to_cpu(state), path)
    if is_best:
        shutil.copyfile(path, os.path.join(directory, BEST))


def load_checkpoint(directory: str) -> Optional[Dict[str, Any]]:
    """The state :func:`save_checkpoint` wrote, tensors on the CPU; None
    when there is no such file."""
    path = os.path.join(directory, CHECKPOINT)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


_BN_FROM_JAX = {"mean": "running_mean", "var": "running_var",
                "scale": "weight"}
_BN_TO_JAX = {"running_mean": "mean", "running_var": "var"}


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def _transposed(model: nn.Module) -> Set[str]:
    """Names of the model's transposed-conv modules."""
    return {name for name, mod in model.named_modules()
            if isinstance(mod, nn.ConvTranspose2d)}


def _check_matches(state: Dict[str, Any], model: nn.Module, what: str):
    """Raise unless ``state`` has the names and shapes of the model's state
    dict."""
    want = model.state_dict()
    bad = sorted(set(state) ^ set(want)) + [
        k for k in state
        if k in want and tuple(state[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"{what} does not match the model: {bad[:5]}")


def params_from_jax(tree: Dict[str, Any], model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy leaves (a JAX parameter tree) → the state dict
    of ``model``: transposed convs take their own layout, and every name
    and shape is checked against the model's state dict."""
    transposed = _transposed(model)
    state = {}
    for path, value in _flatten(tree):
        parent, _, leaf = path.rpartition(".")
        value = np.asarray(value)
        if leaf == "kernel":
            # (kh, kw, in, out) → (in, out, kh, kw); HWIO → OIHW
            value = value.transpose((2, 3, 0, 1) if parent in transposed
                                    else (3, 2, 0, 1))
            leaf = "weight"
        else:
            leaf = _BN_FROM_JAX.get(leaf, leaf)
        state[f"{parent}.{leaf}" if parent else leaf] = torch.tensor(value)
    _check_matches(state, model, "JAX tree")
    return state


def params_to_jax(state: Dict[str, torch.Tensor], model: nn.Module
                  ) -> Dict[str, Any]:
    """A state dict of ``model`` → nested dict of numpy leaves shaped like
    the JAX tree (the inverse of :func:`params_from_jax`)."""
    _check_matches(state, model, "state dict")
    transposed = _transposed(model)
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        parts = name.split(".")
        parent = ".".join(parts[:-1])
        value = value.detach().cpu().numpy()
        leaf = parts[-1]
        if leaf == "weight" and value.ndim == 4:
            # (in, out, kh, kw) → (kh, kw, in, out); OIHW → HWIO
            value = value.transpose((2, 3, 0, 1) if parent in transposed
                                    else (2, 3, 1, 0))
            leaf = "kernel"
        elif leaf == "weight" and value.ndim == 1:   # batch-norm scale
            leaf = "scale"
        else:
            leaf = _BN_TO_JAX.get(leaf, leaf)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def vgg16_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's VGG16 loss params (``{'conv_i': {'kernel' HWIO,
    'bias'}}``, ``core/losses.init_vgg16_params``) → the port's loss params
    (``{'conv_i': {'weight' OIHW, 'bias'}}``), every name and shape checked
    against ``core/losses.vgg16_shapes``."""
    from .losses import vgg16_shapes
    shapes = vgg16_shapes()
    if set(tree) != set(shapes):
        raise ValueError(f"VGG16 tree names {sorted(tree)} are not "
                         f"{sorted(shapes)}")
    params = {}
    for name, (w_shape, b_shape) in shapes.items():
        w = torch.tensor(np.asarray(tree[name]["kernel"]).transpose(3, 2, 0,
                                                                    1))
        b = torch.tensor(np.asarray(tree[name]["bias"]))
        if tuple(w.shape) != w_shape or tuple(b.shape) != b_shape:
            raise ValueError(f"VGG16 {name}: {tuple(w.shape)}, "
                             f"{tuple(b.shape)}; want {w_shape}, {b_shape}")
        params[name] = {"weight": w, "bias": b}
    return params


def vgg16_params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`vgg16_params_from_jax`."""
    return {name: {"kernel": np.ascontiguousarray(
                       p["weight"].detach().cpu().numpy().transpose(2, 3, 1,
                                                                    0)),
                   "bias": p["bias"].detach().cpu().numpy()}
            for name, p in params.items()}


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
