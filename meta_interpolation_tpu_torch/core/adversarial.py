"""Adversarial losses — GAN, WGAN and WGAN-GP with their own discriminator.

Counterpart of ``meta_interpolation_tpu/core/adversarial.py`` (reference
``loss.py:82-236``), in NCHW. The discriminator is 8 blocks of a bias-free
3×3 conv, batch norm on the batch's statistics (no running statistics)
and LeakyReLU(0.2), strides 1, 2 alternating and channels 64 → 512, over a
center crop of ``patch_size``; then Linear(·, 1024), LeakyReLU(0.2),
Linear(1024, 1).

As in the JAX package, the generator term (:func:`generator_loss`) is a
pure function of the discriminator's parameters, which the episode hands
to the loss as ``ctx={'disc': params}``, and the discriminator is updated
outside the episode (:meth:`AdversarialState.update_discriminator`), once
an outer iteration or, with ``--disc_per_forward``, once per criterion
call of the reference in its order (:func:`build_replay_sequence`).
Optimizers: Adam β = (0.9, 0.99) at 1e-4, or β = (0, 0.9) at 1e-5 for
WGAN-GP; WGAN clamps every parameter to ±1 after its step; WGAN-GP adds
10× a gradient penalty on interpolates of the fake and the real.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models import layers

GAN_TYPES = ("GAN", "WGAN", "WGAN_GP")

# (in, out, stride) of each block (JAX _CHANNELS, reference loss.py:98-115)
CHANNELS = [(3, 64, 1)]
for _i in range(7):
    _c = CHANNELS[-1][1]
    CHANNELS.append((_c, _c * 2, 1) if _i % 2 == 1 else (_c, _c, 2))


def feature_patch(patch_size: int) -> int:
    """The side of the last block's output: each stride-2 pad-1 conv gives
    ceil(in / 2). The reference sizes its classifier with floor division,
    which agrees only for multiples of 16 (JAX ``init_discriminator``)."""
    for _, _, stride in CHANNELS:
        if stride == 2:
            patch_size = (patch_size - 1) // 2 + 1
    return patch_size


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = layers.torch_default_init_(
            nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False),
            generator)
        self.bn = nn.BatchNorm2d(cout, track_running_stats=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the batch's statistics, always: the discriminator only trains
        x = F.batch_norm(self.conv(x), None, None, self.bn.weight,
                         self.bn.bias, training=True, eps=1e-5)
        return layers.leaky_relu(x, 0.2)


class Discriminator(nn.Module):
    """``forward(x)``: (N, 3, H, W) → (N, 1) logits on the center
    ``patch_size`` crop, zero-padded at the bottom and right first when H
    or W is thinner (JAX ``discriminator_apply``)."""

    def __init__(self, patch_size: int = 96,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.features = nn.Sequential(*[
            _Block(cin, cout, stride, generator)
            for cin, cout, stride in CHANNELS])
        flat = CHANNELS[-1][1] * feature_patch(patch_size) ** 2
        self.classifier = nn.Sequential(
            layers.torch_default_init_(nn.Linear(flat, 1024), generator),
            nn.LeakyReLU(0.2),
            layers.torch_default_init_(nn.Linear(1024, 1), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers.full_float32()
        p = self.patch_size
        h, w = x.shape[-2], x.shape[-1]
        if h < p or w < p:
            x = F.pad(x, (0, max(0, p - w), 0, max(0, p - h)))
            h, w = x.shape[-2], x.shape[-1]
        top, left = h // 2 - p // 2, w // 2 - p // 2
        x = x[..., top:top + p, left:left + p]
        return self.classifier(self.features(x).flatten(1))


def skeleton(patch_size: int) -> Discriminator:
    """A discriminator without storage, for ``functional_call`` with
    parameters from elsewhere (the loss's ``ctx``)."""
    with torch.device("meta"):
        return Discriminator(patch_size)


def discriminator_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                        patch_size: int = 96,
                        module: Optional[Discriminator] = None
                        ) -> torch.Tensor:
    """The discriminator's logits with ``params`` (its named parameters)."""
    if module is None:
        module = skeleton(patch_size)
    return functional_call(module, params, (x,))


def generator_loss(params: Dict[str, torch.Tensor], fake: torch.Tensor,
                   gan_type: str, patch_size: int = 96,
                   module: Optional[Discriminator] = None) -> torch.Tensor:
    """The generator's adversarial term (reference loss.py:221-230):
    binary cross-entropy of the logits against ones for GAN, −mean of the
    logits for WGAN and WGAN-GP."""
    d_fake = discriminator_apply(params, fake, patch_size, module)
    if gan_type == "GAN":
        return F.binary_cross_entropy_with_logits(d_fake,
                                                  torch.ones_like(d_fake))
    return -d_fake.mean()


def build_replay_sequence(sp: torch.Tensor, qp: Optional[torch.Tensor],
                          final_preds: torch.Tensor, frames: torch.Tensor,
                          support_target_idxs: Sequence[int],
                          query_target_idx: int):
    """The reference's criterion calls of one outer iteration in their
    order, as (fakes, reals), each (N, 1, C, H, W) (JAX
    ``build_replay_sequence``).

    sp (B, S, P, C, H, W): the pre-update support predictions of each
    inner step and pair; qp (B, Sq, C, H, W): the MSL query predictions of
    steps 0..Sq−1, or None; final_preds (B, C, H, W); frames (B, T, C, H,
    W). N = B·(S·P + Sq + 1): tasks one after another; within a task, for
    each step its P support predictions, then (under MSL, steps < Sq) its
    query prediction; then the final query prediction."""
    b, s, p = sp.shape[:3]
    img = tuple(sp.shape[3:])
    sup_t = frames[:, list(support_target_idxs)]               # (B, P, ...)
    sup_t = sup_t[:, None].expand((b, s, p) + img)
    q_t = frames[:, query_target_idx]                          # (B, ...)
    parts_f: List[torch.Tensor] = []
    parts_r: List[torch.Tensor] = []
    sq = 0
    if qp is not None:
        sq = qp.shape[1]
        parts_f.append(torch.cat([sp[:, :sq], qp[:, :, None]], 2).reshape(
            (b, sq * (p + 1)) + img))
        parts_r.append(torch.cat(
            [sup_t[:, :sq], q_t[:, None, None].expand((b, sq, 1) + img)],
            2).reshape((b, sq * (p + 1)) + img))
    parts_f.append(sp[:, sq:].reshape((b, (s - sq) * p) + img))
    parts_r.append(sup_t[:, sq:].reshape((b, (s - sq) * p) + img))
    fakes = torch.cat(parts_f + [final_preds[:, None]], 1)
    reals = torch.cat(parts_r + [q_t[:, None]], 1)
    n_per = fakes.shape[1]
    return (fakes.reshape((b * n_per, 1) + img),
            reals.reshape((b * n_per, 1) + img))


def eps_generator(epoch: int, call: int) -> torch.Generator:
    """The stream of one outer iteration's WGAN-GP interpolation weights:
    seeded from the epoch as the JAX system keys it (epoch·100003 + 17),
    with the iteration's call count folded in, so two iterations of an
    epoch never replay one draw."""
    return torch.Generator().manual_seed(
        (int(epoch) * 100003 + 17) * 1000003 + int(call))


class AdversarialState:
    """The discriminator, its parameters (``params``: detached views of the
    module's, which ``meta_params['loss_ctx']`` shares) and its Adam (JAX
    ``AdversarialState``; torch's Adam computes optax's ``adam``: the same
    bias-corrected moments, eps outside the square root)."""

    def __init__(self, gan_type: str = "GAN", patch_size: int = 96,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        if gan_type not in GAN_TYPES:
            raise ValueError(f"gan_type is one of {GAN_TYPES}, got "
                             f"{gan_type!r}")
        self.gan_type = gan_type
        self.patch_size = patch_size
        self.disc = Discriminator(patch_size, generator).to(device)
        self.disc.requires_grad_(False)
        self.params = {k: p.detach()
                       for k, p in self.disc.named_parameters()}
        self.opt = self.make_optimizer()

    def make_optimizer(self) -> torch.optim.Adam:
        lr, betas = ((1e-5, (0.0, 0.9)) if self.gan_type == "WGAN_GP"
                     else (1e-4, (0.9, 0.99)))
        return torch.optim.Adam(list(self.params.values()), lr=lr,
                                betas=betas, eps=1e-8)

    def d_loss(self, params: Dict[str, torch.Tensor], fake: torch.Tensor,
               real: torch.Tensor, eps: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """The discriminator's loss (reference loss.py:174-207); ``eps``
        (N,) the WGAN-GP interpolation weights."""
        d_fake = discriminator_apply(params, fake, module=self.disc)
        d_real = discriminator_apply(params, real, module=self.disc)
        if self.gan_type == "GAN":
            return (F.binary_cross_entropy_with_logits(
                        d_fake, torch.zeros_like(d_fake))
                    + F.binary_cross_entropy_with_logits(
                        d_real, torch.ones_like(d_real)))
        loss = (d_fake - d_real).mean()
        if self.gan_type == "WGAN_GP":
            eps = eps.to(fake.device, fake.dtype).view(-1, 1, 1, 1)
            hat = (fake * (1 - eps) + real * eps).requires_grad_(True)
            d_hat = discriminator_apply(params, hat, module=self.disc)
            grads, = torch.autograd.grad(d_hat.sum(), hat,
                                         create_graph=True)
            gnorm = torch.sqrt((grads ** 2).sum(dim=(1, 2, 3)) + 1e-12)
            loss = loss + 10.0 * ((gnorm - 1.0) ** 2).mean()
        return loss

    @staticmethod
    def draw_eps(n: int, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """n WGAN-GP interpolation weights, uniform in [0, 1), on the CPU
        (so a card and the CPU draw the same ones)."""
        return torch.rand(n, generator=generator)

    def update_discriminator(self, fake: torch.Tensor, real: torch.Tensor,
                             eps: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
        """One step on a batch of fakes (detached here) and reals. WGAN-GP
        takes ``eps`` (N,) or draws it from ``generator``. Returns the
        loss, detached."""
        if self.gan_type == "WGAN_GP" and eps is None:
            eps = self.draw_eps(fake.shape[0], generator)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss = self.d_loss(leaves, fake.detach(), real, eps)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        for p, g in zip(self.params.values(), grads):
            p.grad = g
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        if self.gan_type == "WGAN":
            with torch.no_grad():
                for p in self.params.values():
                    p.clamp_(-1.0, 1.0)
        return loss.detach()

    def replay(self, fakes: torch.Tensor, reals: torch.Tensor,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``--disc_per_forward``: one single-item update for each row of
        (N, 1, C, H, W) ``fakes`` and ``reals``, in order; ``eps`` (N,) or
        drawn from ``generator``. Returns the N losses."""
        if self.gan_type == "WGAN_GP" and eps is None:
            eps = self.draw_eps(fakes.shape[0], generator)
        return torch.stack([
            self.update_discriminator(
                f, r, None if eps is None else eps[i:i + 1])
            for i, (f, r) in enumerate(zip(fakes, reals))])
