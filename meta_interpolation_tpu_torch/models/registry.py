"""Model registry — dispatch by ``--model`` name.

Counterpart of ``meta_interpolation_tpu/models/registry.py``. SepConv,
RRIN and DAIN are ported so far; every other model of the JAX package
raises ``NotImplementedError`` until its slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from torch import nn

# the JAX package's models, for a clear error on the ones not ported yet
JAX_MODELS = ("cain", "dain", "rrin", "sepconv", "superslomo", "voxelflow")
PORTED = ["dain", "rrin", "sepconv"]


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
    # keyword arguments of every forward inside the meta system. DAIN's
    # flow projection fills holes exactly when the flow does not require
    # grad (reference DepthFlowProjectionLayer.py:42); under the meta
    # system every flow-producing subnet is frozen, so the reference fills
    # holes on every meta forward, adaptation included, and so does the
    # port ({'fill_holes': True}). A standalone forward keeps
    # fill_holes=False, as a freshly built reference MetaDAIN.
    meta_apply_kwargs: Optional[Dict[str, Any]] = None
    # the meta system's loss, (pred, target) → {..., 'total'}; None takes
    # the one --loss names
    loss_fn: Optional[Callable] = None
    # config → keyword arguments of ``build`` (the model's CLI flags)
    build_kwargs: Callable[[Any], Dict[str, Any]] = lambda cfg: {}
    # meta-training (--mode train, --second_order) is ported
    trainable: bool = False


def _identity(x):
    return x


def _rrin_build_kwargs(cfg) -> Dict[str, Any]:
    """--fast_warp_range R > 0 takes the bounded warp (JAX
    meta/system.py:147-149)."""
    return ({"warp_range": cfg.fast_warp_range}
            if cfg.fast_warp_range > 0 else {})


def get(name: str) -> ModelDef:
    name = name.lower()
    if name == "sepconv":
        from . import sepconv
        return ModelDef("sepconv", sepconv.SepConv, _identity, _identity,
                        tile_pixel_limit=5e5,
                        inner_mask_fn=sepconv.inner_mask, trainable=True)
    if name == "rrin":
        from . import rrin
        return ModelDef("rrin", rrin.RRIN, _identity, _identity,
                        tile_pixel_limit=3e5, inner_mask_fn=rrin.inner_mask,
                        build_kwargs=_rrin_build_kwargs)
    if name == "dain":
        from .dain import model as dain

        def charbonnier(pred, target):
            # DAIN trains on its own loss whatever --loss says (JAX
            # meta/system.py:237-246, reference meta_learning_system.py
            # :503-505)
            val = dain.charbonnier_loss(pred, target)
            return {"DAIN": val, "total": val}

        return ModelDef("dain", dain.DAIN, _identity, _identity,
                        inner_mask_fn=dain.inner_mask,
                        meta_apply_kwargs={"fill_holes": True},
                        loss_fn=charbonnier)
    if name in JAX_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; ported: {PORTED}")
    raise NotImplementedError(
        f"Model {name!r} not implemented; available: {PORTED}")
