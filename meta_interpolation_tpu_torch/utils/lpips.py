"""LPIPS (AlexNet variant) — the learned perceptual metric of ``--lpips``.

Counterpart of ``meta_interpolation_tpu/utils/lpips.py`` (the reference's
``evaluate_lpips``, utils.py:207-211, imports the ``lpips`` package): the
inputs in [0, 1] go to [−1, 1], through the fixed shift/scale layer and
torchvision AlexNet's ``features``; the five post-ReLU maps (module indices
1, 4, 7, 9, 11) are normalised to unit length over channels, their squared
differences weighted by the learned 1×1 'lin' vectors, summed over
channels, averaged over space and summed over the five layers. NCHW.

Weights are searched on the VGG weights' path (``core/losses.
vgg_weight_search_dirs``): ``alexnet_features.pth``
(``torchvision.models.alexnet(pretrained=True).features.state_dict()``)
and ``lpips_alex_lins.pth`` (the ``lpips`` package's ``LPIPS(net='alex')``
lin state dict). Without them the metric runs on a random init, with a
loud warning: right in shape, not the published metric.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

# torchvision alexnet().features: (kind, out channels, kernel, stride, pad)
ALEX_LAYERS: List[Tuple[str, int, int, int, int]] = [
    ("conv", 64, 11, 4, 2), ("relu", 0, 0, 0, 0), ("pool", 0, 3, 2, 0),
    ("conv", 192, 5, 1, 2), ("relu", 0, 0, 0, 0), ("pool", 0, 3, 2, 0),
    ("conv", 384, 3, 1, 1), ("relu", 0, 0, 0, 0),
    ("conv", 256, 3, 1, 1), ("relu", 0, 0, 0, 0),
    ("conv", 256, 3, 1, 1), ("relu", 0, 0, 0, 0), ("pool", 0, 3, 2, 0),
]
FEATURE_IDXS = (1, 4, 7, 9, 11)
LIN_CHANNELS = (64, 192, 384, 256, 256)
# the lpips package's ScalingLayer
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)

Params = Dict[str, Dict[str, object]]


def alexnet_shapes() -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Conv ordinal ('0'..'4') → (weight OIHW, bias) shapes."""
    shapes, in_ch = {}, 3
    for kind, out_ch, k, _s, _p in ALEX_LAYERS:
        if kind == "conv":
            shapes[str(len(shapes))] = ((out_ch, in_ch, k, k), (out_ch,))
            in_ch = out_ch
    return shapes


def init_params(generator: Optional[torch.Generator] = None) -> Params:
    """The random fallback (JAX ``init_params``): He-init convs, zero
    biases, lins |N(0, 1)|/C."""
    convs = {}
    for name, (w_shape, b_shape) in alexnet_shapes().items():
        fan_in = w_shape[1] * w_shape[2] * w_shape[3]
        convs[name] = {
            "weight": torch.randn(w_shape, generator=generator)
            * (2.0 / fan_in) ** 0.5,
            "bias": torch.zeros(b_shape)}
    lins = {str(i): (torch.randn((ch,), generator=generator) / ch).abs()
            for i, ch in enumerate(LIN_CHANNELS)}
    return {"convs": convs, "lins": lins}


def load_alexnet_from_torch_state(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """torchvision ``alexnet().features.state_dict()`` → the convs, by
    module index (OIHW, the layout here)."""
    convs, conv_i = {}, 0
    for idx, (kind, *_rest) in enumerate(ALEX_LAYERS):
        if kind == "conv":
            convs[str(conv_i)] = {
                "weight": state[f"{idx}.weight"].detach().float(),
                "bias": state[f"{idx}.bias"].detach().float()}
            conv_i += 1
    return convs


def load_lins_from_torch_state(state) -> Dict[str, torch.Tensor]:
    """The lpips package's lin weights (``lin{i}.model.1.weight`` or
    ``lins.{i}.model.1.weight``, shaped (1, C, 1, 1)) → {'i': (C,)}.
    Raises ``ValueError`` naming the missing layers: a partial dict would
    fail later, far from the cause."""
    lins = {}
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in state:
                lins[str(i)] = state[key].detach().float().reshape(-1)
                break
    missing = [i for i in range(5) if str(i) not in lins]
    if missing:
        raise ValueError(
            f"lins state_dict is missing lin weights for layers {missing}; "
            f"expected lin{{i}}.model.1.weight or lins.{{i}}.model.1.weight "
            f"(got keys like {sorted(state)[:4]})")
    return lins


def load_pretrained() -> Optional[Params]:
    """The pretrained AlexNet and lins from the weights' search path, or
    None with a warning."""
    from ..core import checkpoint as ckpt_lib
    from ..core.losses import find_pretrained_vgg
    alex_path = find_pretrained_vgg("alexnet_features")
    lins_path = find_pretrained_vgg("lpips_alex_lins")
    if alex_path is None or lins_path is None:
        print("[lpips] WARNING: pretrained alexnet_features.pth / "
              "lpips_alex_lins.pth not found on the weights search path — "
              "LPIPS runs on RANDOM-INIT features (not the published "
              "metric). See core/losses.py VGG_WEIGHTS_ENV.",
              file=sys.stderr, flush=True)
        return None
    convs = load_alexnet_from_torch_state(ckpt_lib.load_torch_file(alex_path))
    try:
        lins = load_lins_from_torch_state(ckpt_lib.load_torch_file(lins_path))
    except ValueError as e:
        print(f"[lpips] WARNING: {lins_path} unusable ({e}); LPIPS runs "
              f"on RANDOM-INIT lins.", file=sys.stderr, flush=True)
        return None
    print(f"[lpips] loaded {alex_path} + {lins_path}")
    return {"convs": convs, "lins": lins}


def to_device(params: Params, device) -> Params:
    return {"convs": {k: {n: t.to(device) for n, t in p.items()}
                      for k, p in params["convs"].items()},
            "lins": {k: t.to(device) for k, t in params["lins"].items()}}


def features(convs, x: torch.Tensor) -> List[torch.Tensor]:
    """The five post-ReLU AlexNet maps of NCHW ``x`` (the stack's last
    pool feeds none of them and is not run)."""
    from ..models import layers
    layers.full_float32()
    feats, conv_i = [], 0
    for idx, (kind, _oc, k, s, p) in enumerate(
            ALEX_LAYERS[:FEATURE_IDXS[-1] + 1]):
        if kind == "conv":
            c = convs[str(conv_i)]
            x = F.conv2d(x, c["weight"], c["bias"], stride=s, padding=p)
            conv_i += 1
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = F.max_pool2d(x, k, s)
        if idx in FEATURE_IDXS:
            feats.append(x)
    return feats


def lpips(params: Params, img0: torch.Tensor, img1: torch.Tensor
          ) -> torch.Tensor:
    """LPIPS distance per batch element, (N,), of NCHW inputs in [0, 1]."""
    shift = img0.new_tensor(SHIFT)[:, None, None]
    scale = img0.new_tensor(SCALE)[:, None, None]

    def prep(x):
        return (2.0 * x - 1.0 - shift) / scale

    total = 0.0
    for i, (a, b) in enumerate(zip(features(params["convs"], prep(img0)),
                                   features(params["convs"], prep(img1)))):
        na = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-10)
        nb = b * torch.rsqrt((b * b).sum(1, keepdim=True) + 1e-10)
        w = params["lins"][str(i)][:, None, None]
        total = total + ((na - nb) ** 2 * w).sum(1).mean((1, 2))
    return total
