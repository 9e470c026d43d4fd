"""Loss library — the ``"w1*TYPE1+w2*TYPE2"`` spec and its losses.

Counterpart of ``meta_interpolation_tpu/core/losses.py:37-60, 173-197,
252-414``: ``make_loss_fn(spec)(pred, target, aux=None, ctx=None) -> {type:
weight·loss, …, 'total': sum}``. Ported terms: ``L1``, ``MSE``, ``Charb``,
SuperSloMo's composite ``Super`` (204·recn + 102·warp + 0.005·prcp +
smoothness, with VGG16 conv4_3 features) and ``SuperNoPrcp`` (the same
without the VGG term), and the adversarial generator terms ``GAN``,
``WGAN`` and ``WGAN_GP`` (``core/adversarial.py``). Only the Super terms
read ``aux``, the model's intermediates, and only the adversarial ones
``ctx``, which carries the discriminator's parameters as
``{'disc': params}``. The others of the JAX package (SSIM, VGG19) raise
``NotImplementedError`` until their slice.

The VGG16 weights belong to the loss, not to the meta-parameters: a
torchvision ``vgg16().features`` state dict named ``vgg16_features.pth`` in
one of :func:`vgg_weight_search_dirs`, or else a He init with a loud
warning, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models import layers


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred, target, epsilon=1e-6):
    return torch.mean(torch.sqrt((pred - target) ** 2 + epsilon))


_PIXEL_LOSSES = {"L1": l1_loss, "MSE": mse_loss, "Charb": charbonnier_loss}
_SUPER = ("Super", "SuperNoPrcp")
_GAN = ("GAN", "WGAN", "WGAN_GP")

# ---------------------------------------------------------------------------
# VGG16 features to conv4_3 (torchvision vgg16().features[:22])
# ---------------------------------------------------------------------------

VGG16_LAYERS: List[Tuple[str, int]] = [
    ("conv", 64), ("relu", 0), ("conv", 64), ("relu", 0), ("pool", 0),
    ("conv", 128), ("relu", 0), ("conv", 128), ("relu", 0), ("pool", 0),
    ("conv", 256), ("relu", 0), ("conv", 256), ("relu", 0), ("conv", 256),
    ("relu", 0), ("pool", 0),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
]
VggParams = Dict[str, Dict[str, torch.Tensor]]


def vgg16_shapes() -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """``conv_i`` → (weight OIHW, bias) shapes, in layer order."""
    shapes, in_ch = {}, 3
    for kind, out_ch in VGG16_LAYERS:
        if kind == "conv":
            shapes[f"conv_{len(shapes)}"] = ((out_ch, in_ch, 3, 3),
                                             (out_ch,))
            in_ch = out_ch
    return shapes


def init_vgg16_params(generator: Optional[torch.Generator] = None
                      ) -> VggParams:
    """He init: weight N(0, 2/fan_in) with fan_in = 9·in, bias zero (JAX
    ``_init_vgg_params``, ``core/losses.py:85-101``). Keeps the loss
    working, with the right shapes, when no pretrained file is found."""
    params = {}
    for name, (w_shape, b_shape) in vgg16_shapes().items():
        fan_in = w_shape[1] * 9
        w = torch.randn(w_shape, generator=generator) * (2.0 / fan_in) ** 0.5
        params[name] = {"weight": w, "bias": torch.zeros(b_shape)}
    return params


def vgg16_from_torchvision(state: Dict[str, torch.Tensor]) -> VggParams:
    """A torchvision ``vgg16().features.state_dict()`` (OIHW, the layout
    here) → the loss's params, by module index."""
    params, conv_i = {}, 0
    for idx, (kind, _) in enumerate(VGG16_LAYERS):
        if kind == "conv":
            params[f"conv_{conv_i}"] = {
                "weight": state[f"{idx}.weight"].detach().float(),
                "bias": state[f"{idx}.bias"].detach().float()}
            conv_i += 1
    return params


def vgg16_features(params: VggParams, x: torch.Tensor) -> torch.Tensor:
    """VGG16 to conv4_3 with no trailing ReLU, NCHW (JAX
    ``vgg16_features``, ``core/losses.py:286-316``). Full float32 on the
    card: it runs outside any model forward."""
    layers.full_float32()
    conv_i = 0
    for kind, _ in VGG16_LAYERS:
        if kind == "conv":
            p = params[f"conv_{conv_i}"]
            x = F.conv2d(x, p["weight"], p["bias"], padding=1)
            conv_i += 1
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = F.max_pool2d(x, 2)
    return x


# Pretrained-weight search path (JAX core/losses.py:139-170): a torch state
# dict of torchvision's vgg16(pretrained=True).features, named
# vgg16_features.pth, in
#   1. $MIT_VGG_WEIGHTS (a directory)
#   2. ./pretrained_models/
#   3. ~/.cache/meta_interpolation_tpu/weights/
VGG_WEIGHTS_ENV = "MIT_VGG_WEIGHTS"


def vgg_weight_search_dirs() -> List[str]:
    dirs = []
    env = os.environ.get(VGG_WEIGHTS_ENV)
    if env:
        dirs.append(env)
    dirs.append("pretrained_models")
    dirs.append(os.path.expanduser("~/.cache/meta_interpolation_tpu/weights"))
    return dirs


def find_pretrained_vgg(name: str) -> Optional[str]:
    """The first ``{name}.pth`` on the search path, or None."""
    for d in vgg_weight_search_dirs():
        path = os.path.join(d, f"{name}.pth")
        if os.path.isfile(path):
            return path
    return None


def load_pretrained_vgg16_or_warn() -> Optional[VggParams]:
    """The pretrained VGG16 features, or None with a loud warning: a Super
    loss on random features optimises another objective (JAX
    ``_load_pretrained_or_warn``, ``core/losses.py:173-197``)."""
    name = "vgg16_features"
    path = find_pretrained_vgg(name)
    if path is not None:
        from . import checkpoint as ckpt_lib
        params = vgg16_from_torchvision(ckpt_lib.load_torch_file(path))
        print(f"[losses] loaded pretrained vgg16 features from {path}")
        return params
    print(
        f"\n{'!' * 72}\n"
        f"[losses] WARNING: no pretrained vgg16 weights found — the "
        f"perceptual/Super loss will run on RANDOM-INIT features.\n"
        f"         The reference defines these losses by torchvision "
        f"weights (loss.py:19-78); numbers will NOT match it.\n"
        f"         Provide {name}.pth in one of: "
        f"{vgg_weight_search_dirs()}\n"
        f"         (torch.save(torchvision.models.vgg16(pretrained=True)"
        f".features.state_dict(), '{name}.pth'))\n{'!' * 72}\n",
        file=sys.stderr, flush=True)
    return None


# ---------------------------------------------------------------------------
# SuperSloMo composite loss
# ---------------------------------------------------------------------------

def _tv(f: torch.Tensor) -> torch.Tensor:
    """Mean absolute difference of neighbours along W plus along H."""
    return (torch.mean(torch.abs(f[..., :-1] - f[..., 1:]))
            + torch.mean(torch.abs(f[..., :-1, :] - f[..., 1:, :])))


def superslomo_loss(pred, target, aux: Dict[str, Any],
                    vgg16_params: Optional[VggParams] = None):
    """204·recn + 102·warp + 0.005·prcp + smoothness (JAX
    ``superslomo_loss``, ``core/losses.py:252-281``; reference
    loss.py:246-274). ``aux`` holds the model's ``bidirectional_flow``
    (F_0_1, F_1_0), ``warped_intermediate_frames`` (I_0_t, I_1_t),
    ``warped_input_frames`` (I_0_1, I_1_0) and the inputs ``I0``, ``I1``,
    all NCHW. ``vgg16_params`` None leaves the perceptual term out."""
    f_0_1, f_1_0 = aux["bidirectional_flow"]
    i_0_t, i_1_t = aux["warped_intermediate_frames"]
    i_0_1, i_1_0 = aux["warped_input_frames"]
    i0, i1 = aux["I0"], aux["I1"]
    recn = l1_loss(pred, target)
    prcp = 0.0
    if vgg16_params is not None:
        with torch.no_grad():
            f_tgt = vgg16_features(vgg16_params, target)
        prcp = mse_loss(vgg16_features(vgg16_params, pred), f_tgt)
    warp = (l1_loss(i_0_t, target) + l1_loss(i_1_t, target)
            + l1_loss(i_0_1, i1) + l1_loss(i_1_0, i0))
    smooth = _tv(f_1_0) + _tv(f_0_1)
    return 204.0 * recn + 102.0 * warp + 0.005 * prcp + smooth


# ---------------------------------------------------------------------------
# Spec parser → loss
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LossSpec:
    weight: float
    loss_type: str


def parse_loss_spec(spec: str) -> List[LossSpec]:
    """Parse ``"1*L1+0.1*VGG22"`` (reference loss.py:285-298)."""
    out = []
    for term in spec.split("+"):
        weight, loss_type = term.split("*")
        out.append(LossSpec(float(weight), loss_type))
    return out


class LossFn:
    """``(pred, target, aux=None, ctx=None) -> {type: weight·loss, …,
    'total'}``. ``vgg16_params`` are the Super term's VGG16 weights (None
    without one); reassign them to swap the weights. An adversarial term
    runs the discriminator of ``patch_size`` on ``ctx['disc']`` (JAX
    ``make_loss_fn``, ``core/losses.py:370-416``), and raises without it."""

    def __init__(self, terms: List[LossSpec],
                 vgg16_params: Optional[VggParams], patch_size: int = 96):
        self.terms = terms
        self.vgg16_params = vgg16_params
        self.patch_size = patch_size
        self.disc = None
        if any(t.loss_type in _GAN for t in terms):
            from . import adversarial
            self.disc = adversarial.skeleton(patch_size)

    def __call__(self, pred, target, aux: Optional[Dict[str, Any]] = None,
                 ctx: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        for t in self.terms:
            if t.loss_type in _SUPER:
                val = superslomo_loss(
                    pred, target, aux or {},
                    self.vgg16_params if t.loss_type == "Super" else None)
            elif t.loss_type in _GAN:
                if ctx is None or "disc" not in ctx:
                    raise ValueError(
                        "adversarial loss needs ctx={'disc': params}, "
                        "which SceneAdaptiveInterpolation wires when --loss "
                        "has a GAN term")
                from .adversarial import generator_loss
                val = generator_loss(ctx["disc"], pred, t.loss_type,
                                     self.patch_size, self.disc)
            else:
                val = _PIXEL_LOSSES[t.loss_type](pred, target)
            eff = t.weight * val
            losses[t.loss_type] = eff
            total = total + eff
        losses["total"] = total
        return losses


def make_loss_fn(spec: str, vgg16_params: Optional[VggParams] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cpu",
                 patch_size: int = 96
                 ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The loss of ``spec``. A ``Super`` term takes ``vgg16_params``, else
    the pretrained file, else :func:`init_vgg16_params` from
    ``generator``; they are moved to ``device``. An adversarial term's
    discriminator sees a center crop of ``patch_size``."""
    terms = parse_loss_spec(spec)
    ported = sorted(_PIXEL_LOSSES) + list(_SUPER) + list(_GAN)
    for t in terms:
        if t.loss_type not in ported:
            raise NotImplementedError(
                f"loss {t.loss_type!r} is not ported to PyTorch yet; "
                f"ported: {ported}")
    if any(t.loss_type == "Super" for t in terms):
        if vgg16_params is None:
            vgg16_params = load_pretrained_vgg16_or_warn()
        if vgg16_params is None:
            vgg16_params = init_vgg16_params(generator)
        vgg16_params = {name: {k: v.to(device) for k, v in p.items()}
                        for name, p in vgg16_params.items()}
    else:
        vgg16_params = None
    return LossFn(terms, vgg16_params, patch_size)
