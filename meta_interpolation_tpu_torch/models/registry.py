"""Model registry — dispatch by ``--model`` name.

Counterpart of ``meta_interpolation_tpu/models/registry.py``: CAIN,
SepConv, RRIN, DAIN, SuperSloMo and VoxelFlow, each evaluated and
meta-trained.

``normalize`` maps a [0, 1] clip to model input space on numpy arrays with
the channel last (the datasets'); ``denormalize`` maps back on tensors
with the channel third from last (the episode's NCHW and CHW frames).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

PORTED = ["cain", "dain", "rrin", "sepconv", "superslomo", "voxelflow"]


@dataclasses.dataclass(frozen=True)
class ModelDef:
    name: str
    # (generator, **model kwargs) → the model with freshly initialised
    # weights
    build: Callable[..., nn.Module]
    # map [0,1] frames → model input space, and model output → [0,1]
    normalize: Callable
    denormalize: Callable
    # eval-tiling threshold on H*W (reference experiment_builder.py:103-104)
    tile_pixel_limit: float = 5e5
    # model → {param name: adapted in the inner loop?}
    inner_mask_fn: Optional[Callable[[nn.Module], Dict[str, bool]]] = None
    # model → {param name: trained by the outer optimizer?}; None trains
    # every parameter (buffers, such as frozen BN statistics, never train)
    outer_mask_fn: Optional[Callable[[nn.Module], Dict[str, bool]]] = None
    # (cfg, meta_params) → the outer optimizer's parameter groups, each a
    # dict of torch.optim options plus ``lr_scale`` (its rate over the
    # outer rate); None puts every meta-parameter in one group
    outer_groups: Optional[Callable[[Any, Dict[str, Dict[str, Any]]],
                                    list]] = None
    # keyword arguments of every forward inside the meta system. DAIN's
    # flow projection fills holes exactly when the flow does not require
    # grad (reference DepthFlowProjectionLayer.py:42); under the meta
    # system every flow-producing subnet is frozen, so the reference fills
    # holes on every meta forward, adaptation included, and so does the
    # port ({'fill_holes': True}). A standalone forward keeps
    # fill_holes=False, as a freshly built reference MetaDAIN.
    meta_apply_kwargs: Optional[Dict[str, Any]] = None
    # the meta system's loss, (pred, target, aux) → {..., 'total'}; None
    # takes the one --loss names
    loss_fn: Optional[Callable] = None
    # config → keyword arguments of ``build`` (the model's CLI flags)
    build_kwargs: Callable[[Any], Dict[str, Any]] = lambda cfg: {}
    # meta-training (--mode train, --second_order) is ported
    trainable: bool = False
    # the forward returns (pred, aux) and the loss reads aux
    returns_aux: bool = False
    # (num_steps, device) → per-step BN running statistics for
    # --per_step_bn_statistics (JAX registry.py:48-53); a model with it
    # takes forward(..., bn_state=..., num_step=...) and returns (pred,
    # new_bn_state)
    bn_state_init_fn: Optional[Callable[..., Dict[str, torch.Tensor]]] = None


def _identity(x):
    return x


def _cain_build_kwargs(cfg) -> Dict[str, Any]:
    """--depth, --n_resblocks, --pad_multiple and the border mode: a
    --fuse_groups token overrides --fuse_pad (JAX meta/system.py
    :134-146)."""
    from . import cain
    fuse = cfg.fuse_pad_mode
    if cfg.fuse_groups:
        fuse = cain.parse_fuse_spec(cfg.fuse_groups,
                                    n_resblocks=cfg.n_resblocks)
    return {"depth": cfg.depth, "n_resblocks": cfg.n_resblocks,
            "pad_multiple": cfg.pad_multiple, "fuse_pad": fuse}


def _warp_build_kwargs(cfg) -> Dict[str, Any]:
    """--fast_warp_range R > 0 takes the bounded warp, for each model that
    warps by a grid (JAX meta/system.py:147-149)."""
    return ({"warp_range": cfg.fast_warp_range}
            if cfg.fast_warp_range > 0 else {})


def _vf_build_kwargs(cfg) -> Dict[str, Any]:
    """The warp flags, and per-step BN affine rows under
    --per_step_bn_statistics without
    --enable_inner_loop_optimizable_bn_params (JAX meta/system.py
    :154-163): outer-trainable, never inner-adapted."""
    kwargs = _warp_build_kwargs(cfg)
    if (cfg.per_step_bn_statistics
            and not cfg.enable_inner_loop_optimizable_bn_params):
        kwargs["per_step_bn_affine"] = cfg.num_inner_steps
    return kwargs


# SuperSloMo's input mean (JAX models/registry.py:110-119)
SSM_MEAN = np.asarray([0.429, 0.431, 0.397], np.float32)


def _ssm_normalize(x: np.ndarray) -> np.ndarray:
    return x - SSM_MEAN


def _ssm_denormalize(x: torch.Tensor) -> torch.Tensor:
    return x + torch.as_tensor(SSM_MEAN, device=x.device)[:, None, None]


def _vf_normalize(x):
    # the reference keeps 0-255, then Normalize(mean=127.5, std=127.5)
    return (x * 255.0 - 127.5) / 127.5


def _vf_denormalize(x: torch.Tensor) -> torch.Tensor:
    # divided by a tensor on x's device: CUDA divides by a Python scalar as
    # a product with its reciprocal, which differs from the CPU's division
    # in the last bit, and the metrics' 8-bit rounding turns such a bit at
    # a tie into a whole level
    return (x * 127.5 + 127.5) / x.new_full((), 255.0)


def _vf_outer_groups(cfg, meta_params) -> Optional[list]:
    """VoxelFlow's outer Adam (JAX ``make_outer_optimizer``,
    ``meta/system.py:79-107``; reference ``get_optim_policies``,
    voxel_flow.py:307-350), torch's default β = (0.9, 0.999): conv weights
    at the rate with weight decay, conv biases at twice the rate without,
    BN scale and bias at the rate with decay, the inner rates at the rate
    without. torch.optim.Adam's decay adds wd·p to the gradient before the
    moments, as optax's ``add_decayed_weights`` before ``scale_by_adam``.
    None (one group) under another rule."""
    if cfg.optimizer != "Adam":
        return None
    kinds = {"conv weights": [], "conv biases": [], "bn affine": []}
    for name, p in meta_params["net"].items():
        *parents, leaf = name.split(".")
        if any(q.endswith("_bn") for q in parents):
            kinds["bn affine"].append(p)
        else:
            kinds["conv biases" if leaf == "bias" else "conv weights"].append(
                p)
    kinds["inner rates"] = list(meta_params["lrs"].values())
    if "attenuator" in meta_params:
        # JAX's policy puts everything outside the net on plain Adam
        kinds["attenuator"] = list(meta_params["attenuator"].values())
    decay = cfg.weight_decay
    return [{"name": kind, "params": params, "betas": (0.9, 0.999),
             "lr_scale": 2.0 if kind == "conv biases" else 1.0,
             "weight_decay": decay if kind in ("conv weights", "bn affine")
             else 0.0}
            for kind, params in kinds.items()]


def get(name: str) -> ModelDef:
    name = name.lower()
    if name == "cain":
        from . import cain
        return ModelDef("cain", cain.CAIN, _identity, _identity,
                        tile_pixel_limit=5e5,
                        build_kwargs=_cain_build_kwargs, trainable=True)
    if name == "sepconv":
        from . import sepconv
        return ModelDef("sepconv", sepconv.SepConv, _identity, _identity,
                        tile_pixel_limit=5e5,
                        inner_mask_fn=sepconv.inner_mask, trainable=True)
    if name == "rrin":
        from . import rrin
        return ModelDef("rrin", rrin.RRIN, _identity, _identity,
                        tile_pixel_limit=3e5, inner_mask_fn=rrin.inner_mask,
                        build_kwargs=_warp_build_kwargs, trainable=True)
    if name == "superslomo":
        from . import superslomo
        return ModelDef("superslomo", superslomo.SuperSloMo, _ssm_normalize,
                        _ssm_denormalize, build_kwargs=_warp_build_kwargs,
                        returns_aux=True, trainable=True)
    if name == "voxelflow":
        from . import voxelflow
        return ModelDef("voxelflow", voxelflow.VoxelFlow, _vf_normalize,
                        _vf_denormalize, inner_mask_fn=voxelflow.inner_mask,
                        build_kwargs=_vf_build_kwargs,
                        outer_groups=_vf_outer_groups, trainable=True,
                        bn_state_init_fn=voxelflow.init_bn_state)
    if name == "dain":
        from .dain import model as dain

        def charbonnier(pred, target, aux=None, ctx=None):
            # DAIN trains on its own loss whatever --loss says (JAX
            # meta/system.py:237-246, reference meta_learning_system.py
            # :503-505)
            val = dain.charbonnier_loss(pred, target)
            return {"DAIN": val, "total": val}

        return ModelDef("dain", dain.DAIN, _identity, _identity,
                        inner_mask_fn=dain.inner_mask,
                        outer_mask_fn=dain.outer_mask,
                        meta_apply_kwargs={"fill_holes": True},
                        loss_fn=charbonnier, trainable=True)
    raise NotImplementedError(
        f"Model {name!r} not implemented; available: {PORTED}")
