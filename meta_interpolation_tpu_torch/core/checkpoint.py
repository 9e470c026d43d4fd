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

The VGG16 weights of SuperSloMo's ``Super`` loss and the VGG19 weights of
the perceptual terms, which are the loss's and not the model's, bridge
with :func:`vgg16_params_from_jax` and :func:`vgg19_params_from_jax`, and
LPIPS's AlexNet and lins with :func:`lpips_params_from_jax`. The other
groups of the meta-parameters bridge with :func:`attenuator_from_jax`
(L2F), :func:`bn_state_from_jax` (per-step BN statistics) and
:func:`disc_params_from_jax` (the adversarial loss's discriminator);
:func:`load_jax_meta_params` loads every group of a JAX system's
meta-parameters into a port system.
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


def _vgg_params_from_jax(tree: Dict[str, Any], shapes, what: str,
                         prefix_ok: bool) -> Dict[str, Any]:
    """A JAX VGG tree (``{'conv_i': {'kernel' HWIO, 'bias'}}``) → the
    port's (``{'conv_i': {'weight' OIHW, 'bias'}}``), every name and shape
    checked against ``shapes``; with ``prefix_ok`` the first k convs of it
    (a stack cut short, as ``init_vgg19_params(max_cut)`` makes)."""
    want = list(shapes)[:len(tree)] if prefix_ok else list(shapes)
    if set(tree) != set(want):
        raise ValueError(f"{what} tree names {sorted(tree)} are not "
                         f"{sorted(want)}")
    params = {}
    for name in want:
        w_shape, b_shape = shapes[name]
        w = torch.tensor(np.asarray(tree[name]["kernel"]).transpose(3, 2, 0,
                                                                    1))
        b = torch.tensor(np.asarray(tree[name]["bias"]))
        if tuple(w.shape) != w_shape or tuple(b.shape) != b_shape:
            raise ValueError(f"{what} {name}: {tuple(w.shape)}, "
                             f"{tuple(b.shape)}; want {w_shape}, {b_shape}")
        params[name] = {"weight": w, "bias": b}
    return params


def vgg16_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's VGG16 loss params (``core/losses.
    init_vgg16_params``) → the port's loss params, every name and shape
    checked against ``core/losses.vgg16_shapes``."""
    from .losses import VGG16_LAYERS, vgg_shapes
    return _vgg_params_from_jax(tree, vgg_shapes(VGG16_LAYERS), "VGG16",
                                prefix_ok=False)


def vgg19_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's VGG19 loss params (``core/losses.
    init_vgg19_params(max_cut)``: the convs to that cut) → the port's."""
    from .losses import VGG19_LAYERS, vgg_shapes
    return _vgg_params_from_jax(tree, vgg_shapes(VGG19_LAYERS), "VGG19",
                                prefix_ok=True)


def vgg16_params_to_jax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`vgg16_params_from_jax` (and of
    :func:`vgg19_params_from_jax`)."""
    return {name: {"kernel": np.ascontiguousarray(
                       p["weight"].detach().cpu().numpy().transpose(2, 3, 1,
                                                                    0)),
                   "bias": p["bias"].detach().cpu().numpy()}
            for name, p in params.items()}


vgg19_params_to_jax = vgg16_params_to_jax


def lpips_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's LPIPS params (``utils/lpips``: ``{'convs': {'i':
    {'kernel' HWIO, 'bias'}}, 'lins': {'i': (C,)}}``) → the port's
    (``{'convs': {'i': {'weight' OIHW, 'bias'}}, 'lins': {'i': (C,)}}``),
    every shape checked against ``utils/lpips.alexnet_shapes``."""
    from ..utils.lpips import LIN_CHANNELS, alexnet_shapes
    shapes = alexnet_shapes()
    if set(tree.get("convs", {})) != set(shapes) or set(
            tree.get("lins", {})) != {str(i) for i in range(5)}:
        raise ValueError(f"LPIPS tree: convs {sorted(tree.get('convs', {}))}"
                         f", lins {sorted(tree.get('lins', {}))}")
    convs = {}
    for name, (w_shape, b_shape) in shapes.items():
        p = tree["convs"][name]
        w = torch.tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        b = torch.tensor(np.asarray(p["bias"]))
        if tuple(w.shape) != w_shape or tuple(b.shape) != b_shape:
            raise ValueError(f"LPIPS conv {name}: {tuple(w.shape)}; want "
                             f"{w_shape}")
        convs[name] = {"weight": w, "bias": b}
    lins = {str(i): torch.tensor(np.asarray(tree["lins"][str(i)]))
            for i in range(5)}
    for i, ch in enumerate(LIN_CHANNELS):
        if tuple(lins[str(i)].shape) != (ch,):
            raise ValueError(f"LPIPS lin {i}: {tuple(lins[str(i)].shape)}")
    return {"convs": convs, "lins": lins}


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


def _jax_leaf_name(path: str) -> str:
    parent, _, leaf = path.rpartition(".")
    leaf = "weight" if leaf == "kernel" else _BN_FROM_JAX.get(leaf, leaf)
    return f"{parent}.{leaf}" if parent else leaf


def jax_leaf_order(tree: Dict[str, Any]) -> list:
    """The port names of a JAX net tree's leaves in ``jax.tree.leaves``
    order: the key paths sorted at every level."""
    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                yield from walk(node[key], f"{prefix}{key}.")
            else:
                yield _jax_leaf_name(f"{prefix}{key}")
    return list(walk(tree, ""))


def attenuator_from_jax(tree: Dict[str, Any], net_tree: Dict[str, Any],
                        kept: list) -> Dict[str, torch.Tensor]:
    """The JAX attenuator (``fc1``/``fc2`` kernels (in, out), ``bias``,
    ``gamma_mult``) → the port's (``nn.Linear`` layout (out, in)).

    JAX's gamma[j] scales the j-th kept leaf in ``jax.tree.leaves`` order
    of ``net_tree``; the port's gamma[i] scales ``kept[i]``, the kept
    tensors in ``named_parameters()`` order (the reference's
    ``names_weights_copy`` order). So fc1's inputs and fc2's outputs (and
    fc2's bias) are permuted, and gamma lands on the same tensor."""
    jax_kept = [k for k in jax_leaf_order(net_tree) if k in set(kept)]
    if sorted(jax_kept) != sorted(kept):
        raise ValueError(f"the JAX net tree's kept leaves differ from the "
                         f"port's: {sorted(set(kept) ^ set(jax_kept))[:5]}")
    # port index of each JAX index
    order = torch.tensor([kept.index(k) for k in jax_kept])
    k1 = torch.tensor(np.asarray(tree["fc1"]["kernel"]))    # (L_in, H)
    k2 = torch.tensor(np.asarray(tree["fc2"]["kernel"]))    # (H, L_out)
    b2 = torch.tensor(np.asarray(tree["fc2"]["bias"]))
    w1 = torch.empty_like(k1.T)
    w1[:, order] = k1.T
    w2 = torch.empty_like(k2.T)
    w2[order] = k2.T
    b2p = torch.empty_like(b2)
    b2p[order] = b2
    return {"fc1.weight": w1, "fc1.bias": torch.tensor(
                np.asarray(tree["fc1"]["bias"])),
            "fc2.weight": w2, "fc2.bias": b2p,
            "gamma_mult": torch.tensor(np.asarray(tree["gamma_mult"]))}


def bn_state_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX per-step BN statistics ``{bn: {'running_mean', 'running_var'}}``
    → ``{'<bn>.running_mean': (S, C), ...}``."""
    return {path: torch.tensor(np.asarray(value))
            for path, value in _flatten(tree)}


def disc_params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX discriminator (``core/adversarial.init_discriminator``) →
    ``Discriminator``'s named parameters: conv kernels HWIO → OIHW, BN
    ``scale`` → ``weight`` (the unused ``mean``/``var`` dropped), linear
    kernels (in, out) → (out, in). JAX flattens the last features NHWC
    and the port NCHW, as the reference, so the first linear's input
    columns go from (H, W, C) to (C, H, W) order."""
    out = {}
    for i, blk in tree["features"].items():
        out[f"features.{i}.conv.weight"] = torch.tensor(
            np.asarray(blk["conv"]["kernel"]).transpose(3, 2, 0, 1))
        out[f"features.{i}.bn.weight"] = torch.tensor(
            np.asarray(blk["bn"]["scale"]))
        out[f"features.{i}.bn.bias"] = torch.tensor(
            np.asarray(blk["bn"]["bias"]))
    last = tree["features"][str(len(tree["features"]) - 1)]
    ch = np.asarray(last["conv"]["kernel"]).shape[-1]
    k0 = np.asarray(tree["classifier"]["0"]["kernel"])
    side = int(round((k0.shape[0] // ch) ** 0.5))
    k0 = k0.reshape(side, side, ch, -1).transpose(3, 2, 0, 1)
    out["classifier.0.weight"] = torch.tensor(
        np.ascontiguousarray(k0.reshape(k0.shape[0], -1)))
    out["classifier.2.weight"] = torch.tensor(
        np.asarray(tree["classifier"]["2"]["kernel"]).T.copy())
    for idx in ("0", "2"):
        out[f"classifier.{idx}.bias"] = torch.tensor(
            np.asarray(tree["classifier"][idx]["bias"]))
    return out


def load_jax_meta_params(system, tree: Dict[str, Any]) -> None:
    """Every group of a JAX system's meta-parameters (a tree of numpy
    leaves) into a port ``SceneAdaptiveInterpolation``'s own tensors: the
    net (with its BN statistics), the Meta-SGD inner rates (LSLR's
    per-step vectors are left as they are), and the attenuator, per-step BN
    statistics and discriminator groups where the system has them. The
    discriminator's Adam starts afresh."""
    system.load_net(params_from_jax(tree["net"], system.model))
    groups = {}
    if system.cfg.metasgd:
        groups["lrs"] = {
            k: v for k, v in params_from_jax(tree["lrs"], system.model).items()
            if k in system.meta_params["lrs"]}
    if "attenuator" in system.meta_params:
        kept = [k for k in system.meta_params["net"]
                if system.builder.att_keep is None
                or system.builder.att_keep[k]]
        groups["attenuator"] = attenuator_from_jax(
            tree["attenuator"], tree["net"], kept)
    if "bn_state" in system.meta_params:
        groups["bn_state"] = bn_state_from_jax(tree["bn_state"])
    if "loss_ctx" in system.meta_params:
        groups["loss_ctx"] = disc_params_from_jax(tree["loss_ctx"]["disc"])
        system.adv_state.opt = system.adv_state.make_optimizer()
    with torch.no_grad():
        for g, values in groups.items():
            mine = system.meta_params[g]
            if set(values) != set(mine) or any(
                    values[k].shape != mine[k].shape for k in mine):
                raise ValueError(f"JAX group {g!r} does not match the "
                                 f"port's")
            for k, v in values.items():
                mine[k].copy_(v)

