"""Loss library — the ``"w1*TYPE1+w2*TYPE2"`` spec and its pixel losses.

Counterpart of ``meta_interpolation_tpu/core/losses.py:37-60, 328-414``:
``make_loss_fn(spec)(pred, target) -> {type: weight·loss, …, 'total': sum}``.
Ported terms: ``L1``, ``MSE`` and ``Charb``; the others of the JAX package
(SSIM, VGG, Super, GAN) raise ``NotImplementedError`` until their slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def charbonnier_loss(pred, target, epsilon=1e-6):
    return torch.mean(torch.sqrt((pred - target) ** 2 + epsilon))


_LOSSES = {"L1": l1_loss, "MSE": mse_loss, "Charb": charbonnier_loss}


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


def make_loss_fn(spec: str) -> Callable[..., Dict[str, torch.Tensor]]:
    terms = parse_loss_spec(spec)
    for t in terms:
        if t.loss_type not in _LOSSES:
            raise NotImplementedError(
                f"loss {t.loss_type!r} is not ported to PyTorch yet; "
                f"ported: {sorted(_LOSSES)}")

    def loss_fn(pred, target):
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        for t in terms:
            eff = t.weight * _LOSSES[t.loss_type](pred, target)
            losses[t.loss_type] = eff
            total = total + eff
        losses["total"] = total
        return losses

    return loss_fn
