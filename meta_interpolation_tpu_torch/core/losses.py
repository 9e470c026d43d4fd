"""Loss library — the ``"w1*TYPE1+w2*TYPE2"`` spec and its losses.

Counterpart of ``meta_interpolation_tpu/core/losses.py``: ``make_loss_fn(
spec)(pred, target, aux=None, ctx=None) -> {type: weight·loss, …, 'total':
sum}``. Terms: ``L1``, ``MSE``, ``Charb``, ``SSIM`` (DSSIM, (1 − SSIM)/2
with the range detected from the data), the VGG19 perceptual terms
``VGG22``, ``VGG33``, ``VGG44``, ``VGG54`` and ``VGGP`` (MSE of VGG19
features at one cut, or summed over all four), SuperSloMo's composite
``Super`` (204·recn + 102·warp + 0.005·prcp + smoothness, with VGG16
conv4_3 features) and ``SuperNoPrcp`` (the same without the VGG term), and
the adversarial generator terms ``GAN``, ``WGAN`` and ``WGAN_GP``
(``core/adversarial.py``). Only the Super terms read ``aux``, the model's
intermediates, and only the adversarial ones ``ctx``, which carries the
discriminator's parameters as ``{'disc': params}``.

The VGG weights belong to the loss, not to the meta-parameters: a
torchvision ``vgg19().features`` / ``vgg16().features`` state dict named
``vgg19_features.pth`` / ``vgg16_features.pth`` in one of
:func:`vgg_weight_search_dirs`, or else a He init with a loud warning, as
the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..models import layers
from . import metrics


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred, target, epsilon=1e-6):
    return torch.mean(torch.sqrt((pred - target) ** 2 + epsilon))


def dssim_loss(pred, target):
    """(1 − SSIM)/2 (reference SSIM loss class). The reference class never
    hands its val_range to ssim(), so the range is detected from the data
    (L = 2 in mean-shifted or tanh spaces, 1 in [0, 1]) and carries no
    gradient, as in JAX ``dssim_loss`` (``core/losses.py:45-53``)."""
    return (1.0 - metrics.ssim(pred, target, val_range=None)) / 2.0


_PIXEL_LOSSES = {"L1": l1_loss, "MSE": mse_loss, "Charb": charbonnier_loss,
                 "SSIM": dssim_loss}
_VGG = ("VGG22", "VGG33", "VGG44", "VGG54", "VGGP")
_SUPER = ("Super", "SuperNoPrcp")
_GAN = ("GAN", "WGAN", "WGAN_GP")

# ---------------------------------------------------------------------------
# VGG features: VGG19 (the perceptual terms) and VGG16 to conv4_3 (Super)
# ---------------------------------------------------------------------------

# torchvision vgg19().features, (kind, out channels) by module index: the
# reference cuts the stack by module index (loss.py:24-39)
VGG19_LAYERS: List[Tuple[str, int]] = [
    ("conv", 64), ("relu", 0), ("conv", 64), ("relu", 0), ("pool", 0),
    ("conv", 128), ("relu", 0), ("conv", 128), ("relu", 0), ("pool", 0),
    ("conv", 256), ("relu", 0), ("conv", 256), ("relu", 0), ("conv", 256),
    ("relu", 0), ("conv", 256), ("relu", 0), ("pool", 0),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("conv", 512), ("relu", 0), ("pool", 0),
    ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0), ("conv", 512),
    ("relu", 0), ("conv", 512), ("relu", 0), ("pool", 0),
]
# the module index each VGG{22,33,44,54} term cuts at; VGGP collects all four
VGG_CUTS = {"22": 8, "33": 16, "44": 26, "54": 35}
VGGP_CUTS = (8, 16, 26, 35)
# the reference's MeanShift before VGG19 (loss.py:42-44)
VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)
# torchvision vgg16().features[:22]: to conv4_3, no trailing ReLU
VGG16_LAYERS: List[Tuple[str, int]] = VGG19_LAYERS[:16] + [
    ("pool", 0), ("conv", 512), ("relu", 0), ("conv", 512), ("relu", 0),
    ("conv", 512)]
VggParams = Dict[str, Dict[str, torch.Tensor]]


def vgg_shapes(layer_table) -> Dict[str, Tuple[Tuple[int, ...],
                                                Tuple[int, ...]]]:
    """``conv_i`` → (weight OIHW, bias) shapes of a (kind, out channels)
    layer table, in layer order."""
    shapes, in_ch = {}, 3
    for kind, out_ch in layer_table:
        if kind == "conv":
            shapes[f"conv_{len(shapes)}"] = ((out_ch, in_ch, 3, 3),
                                             (out_ch,))
            in_ch = out_ch
    return shapes


def vgg16_shapes():
    return vgg_shapes(VGG16_LAYERS)


def init_vgg_params(layer_table, generator: Optional[torch.Generator] = None
                    ) -> VggParams:
    """He init: weight N(0, 2/fan_in) with fan_in = 9·in, bias zero (JAX
    ``_init_vgg_params``, ``core/losses.py:85-101``). Keeps a VGG loss
    working, with the right shapes, when no pretrained file is found."""
    params = {}
    for name, (w_shape, b_shape) in vgg_shapes(layer_table).items():
        fan_in = w_shape[1] * 9
        w = torch.randn(w_shape, generator=generator) * (2.0 / fan_in) ** 0.5
        params[name] = {"weight": w, "bias": torch.zeros(b_shape)}
    return params


def init_vgg16_params(generator: Optional[torch.Generator] = None
                      ) -> VggParams:
    return init_vgg_params(VGG16_LAYERS, generator)


def init_vgg19_params(max_cut: int = 35,
                      generator: Optional[torch.Generator] = None
                      ) -> VggParams:
    """He-init VGG19 to torchvision module index ``max_cut``."""
    return init_vgg_params(VGG19_LAYERS[:max_cut], generator)


def vgg_from_torchvision(state: Dict[str, torch.Tensor], layer_table
                         ) -> VggParams:
    """A torchvision ``vggNN().features.state_dict()`` (OIHW, the layout
    here) → the loss's params, by module index, up to the first conv the
    state lacks (JAX ``_load_vgg_from_torch_state``)."""
    params, conv_i = {}, 0
    for idx, (kind, _) in enumerate(layer_table):
        if kind != "conv":
            continue
        if f"{idx}.weight" not in state:
            break
        params[f"conv_{conv_i}"] = {
            "weight": state[f"{idx}.weight"].detach().float(),
            "bias": state[f"{idx}.bias"].detach().float()}
        conv_i += 1
    return params


def load_vgg19_from_torch_state(state: Dict[str, torch.Tensor]
                                ) -> VggParams:
    return vgg_from_torchvision(state, VGG19_LAYERS)


def _vgg_stack(params: VggParams, x: torch.Tensor, layer_table,
               collect=()) -> List[torch.Tensor]:
    """``layer_table`` on NCHW ``x``; the features after each module index
    in ``collect`` (1-based: after module i−1), else the last one."""
    layers.full_float32()
    feats, conv_i = [], 0
    for idx, (kind, _) in enumerate(layer_table):
        if kind == "conv":
            p = params[f"conv_{conv_i}"]
            x = F.conv2d(x, p["weight"], p["bias"], padding=1)
            conv_i += 1
        elif kind == "relu":
            x = torch.relu(x)
        else:
            x = F.max_pool2d(x, 2)
        if idx + 1 in collect:
            feats.append(x)
    return feats if collect else [x]


def vgg16_features(params: VggParams, x: torch.Tensor) -> torch.Tensor:
    """VGG16 to conv4_3 with no trailing ReLU, NCHW (JAX
    ``vgg16_features``, ``core/losses.py:286-316``). Full float32 on the
    card: it runs outside any model forward."""
    return _vgg_stack(params, x, VGG16_LAYERS)[0]


def vgg19_features(params: VggParams, x: torch.Tensor, cut: int,
                   collect: Optional[List[int]] = None):
    """VGG19 to module index ``cut`` on NCHW ``x`` in [0, 1], after the
    reference's MeanShift (JAX ``vgg19_features``, ``core/losses.py
    :208-233``). With ``collect``, the list of features after those module
    indices (VGGP)."""
    mean = x.new_tensor(VGG_MEAN)[:, None, None]
    std = x.new_tensor(VGG_STD)[:, None, None]
    feats = _vgg_stack(params, (x - mean) / std, VGG19_LAYERS[:cut],
                       collect or ())
    return feats if collect is not None else feats[0]


def vgg_perceptual_loss(params: VggParams, pred, target, conv_index: str):
    """MSE in VGG19 feature space, the target's features constant
    (reference loss.py:49-78); ``P`` sums the MSEs at the four cuts."""
    cuts = list(VGGP_CUTS) if conv_index == "P" else None
    cut = 35 if cuts else VGG_CUTS[conv_index]
    with torch.no_grad():
        f_tgt = vgg19_features(params, target, cut, cuts)
    f_pred = vgg19_features(params, pred, cut, cuts)
    if cuts is None:
        return mse_loss(f_pred, f_tgt)
    return sum(mse_loss(a, b) for a, b in zip(f_pred, f_tgt))


# Pretrained-weight search path (JAX core/losses.py:139-170): a torch state
# dict of torchvision's vgg19(pretrained=True).features or
# vgg16(pretrained=True).features, named vgg19_features.pth or
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


def load_pretrained_or_warn(kind: str) -> Optional[VggParams]:
    """The pretrained ``kind`` ('vgg16' or 'vgg19') features, or None with
    a loud warning: a perceptual loss on random features optimises another
    objective (JAX ``_load_pretrained_or_warn``, ``core/losses.py
    :173-197``)."""
    name = f"{kind}_features"
    path = find_pretrained_vgg(name)
    if path is not None:
        from . import checkpoint as ckpt_lib
        params = vgg_from_torchvision(
            ckpt_lib.load_torch_file(path),
            VGG19_LAYERS if kind == "vgg19" else VGG16_LAYERS)
        print(f"[losses] loaded pretrained {kind} features from {path}")
        return params
    print(
        f"\n{'!' * 72}\n"
        f"[losses] WARNING: no pretrained {kind} weights found — the "
        f"perceptual/Super loss will run on RANDOM-INIT features.\n"
        f"         The reference defines these losses by torchvision "
        f"weights (loss.py:19-78); numbers will NOT match it.\n"
        f"         Provide {name}.pth in one of: "
        f"{vgg_weight_search_dirs()}\n"
        f"         (torch.save(torchvision.models.{kind}(pretrained=True)"
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
    'total'}``. ``vgg16_params`` are the Super term's VGG16 weights and
    ``vgg19_params`` the perceptual terms' VGG19 weights (None without
    such a term); reassign them to swap the weights. An adversarial term
    runs the discriminator of ``patch_size`` on ``ctx['disc']`` (JAX
    ``make_loss_fn``, ``core/losses.py:340-416``), and raises without it."""

    def __init__(self, terms: List[LossSpec],
                 vgg16_params: Optional[VggParams], patch_size: int = 96,
                 vgg19_params: Optional[VggParams] = None):
        self.terms = terms
        self.vgg16_params = vgg16_params
        self.vgg19_params = vgg19_params
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
            elif t.loss_type in _VGG:
                val = vgg_perceptual_loss(self.vgg19_params, pred, target,
                                          t.loss_type[3:])
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


def _on(params: VggParams, device) -> VggParams:
    return {name: {k: v.to(device) for k, v in p.items()}
            for name, p in params.items()}


def make_loss_fn(spec: str, vgg16_params: Optional[VggParams] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Union[str, torch.device] = "cpu",
                 patch_size: int = 96,
                 vgg19_params: Optional[VggParams] = None
                 ) -> Callable[..., Dict[str, torch.Tensor]]:
    """The loss of ``spec``. A VGG19 term takes ``vgg19_params``, else the
    pretrained file, else :func:`init_vgg19_params` to the deepest cut the
    spec needs, from ``generator``; a ``Super`` term does the same with
    VGG16. Both are moved to ``device``. An adversarial term's
    discriminator sees a center crop of ``patch_size``. An unknown term
    raises ``ValueError``."""
    terms = parse_loss_spec(spec)
    known = sorted(_PIXEL_LOSSES) + list(_VGG) + list(_SUPER) + list(_GAN)
    for t in terms:
        if t.loss_type not in known:
            raise ValueError(f"unknown loss type: {t.loss_type!r}; known: "
                             f"{known}")
    vgg19_terms = [t.loss_type[3:] for t in terms if t.loss_type in _VGG]
    if vgg19_terms:
        if vgg19_params is None:
            vgg19_params = load_pretrained_or_warn("vgg19")
        if vgg19_params is None:
            vgg19_params = init_vgg19_params(
                max(VGG_CUTS.get(c, 35) for c in vgg19_terms), generator)
        vgg19_params = _on(vgg19_params, device)
    else:
        vgg19_params = None
    if any(t.loss_type == "Super" for t in terms):
        if vgg16_params is None:
            vgg16_params = load_pretrained_or_warn("vgg16")
        if vgg16_params is None:
            vgg16_params = init_vgg16_params(generator)
        vgg16_params = _on(vgg16_params, device)
    else:
        vgg16_params = None
    return LossFn(terms, vgg16_params, patch_size, vgg19_params)
