"""Model registry — dispatch by ``--model`` name.

Counterpart of ``meta_interpolation_tpu/models/registry.py``. SepConv and
RRIN are ported so far; every other model of the JAX package raises
``NotImplementedError`` until its slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from torch import nn

# the JAX package's models, for a clear error on the ones not ported yet
JAX_MODELS = ("cain", "dain", "rrin", "sepconv", "superslomo", "voxelflow")
PORTED = ["rrin", "sepconv"]


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


def _identity(x):
    return x


def get(name: str) -> ModelDef:
    name = name.lower()
    if name == "sepconv":
        from . import sepconv
        return ModelDef("sepconv", sepconv.SepConv, _identity, _identity,
                        tile_pixel_limit=5e5,
                        inner_mask_fn=sepconv.inner_mask)
    if name == "rrin":
        from . import rrin
        return ModelDef("rrin", rrin.RRIN, _identity, _identity,
                        tile_pixel_limit=3e5, inner_mask_fn=rrin.inner_mask)
    if name in JAX_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; ported: {PORTED}")
    raise NotImplementedError(
        f"Model {name!r} not implemented; available: {PORTED}")
