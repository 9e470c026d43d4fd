"""The legacy trainers' command lines (reference ``legacy/train_*.py``).

Counterpart of ``meta_interpolation_tpu/legacy/driver.py``: the four
reference scripts' Reptile / first-order-MAML loops on the steps of
:mod:`.trainers`:

  * ``--meta_algorithm maml``    — inner steps on the support pairs, the
    query gradient at the adapted weights stepped by the outer optimizer
    on the base weights (train_sepconv.py:145-180);
  * ``--meta_algorithm reptile`` — θ ← θ + ε(θ′ − θ) (:113-141);
  * after each epoch a validation: adapt a throwaway copy, the query's
    PSNR, discard (:218-263); a checkpoint, and the best-PSNR one
    (:273-290). ``--mode test`` validates only.

    python -m meta_interpolation_tpu_torch.legacy.train_sepconv    --...
    python -m meta_interpolation_tpu_torch.legacy.train_voxelflow  --...
    python -m meta_interpolation_tpu_torch.legacy.train_superslomo --...
    python -m meta_interpolation_tpu_torch.legacy.train_dain       --...

The outer optimizers take optax's defaults, as the JAX driver's do: Adam
and Adamax with β = (0.9, 0.999) and eps 1e-8, or SGD. Runs on the CUDA
card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import inspect
import os
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class LegacyPreset:
    """A reference script's defaults: its model, optimizers and loss."""
    model: str
    inner_rule: str            # Adamax (sepconv, dain) or Adam (vf, ssm)
    outer_opt: str             # Adamax / Adam / SGD
    loss_spec: str             # core.losses spec ("1*L1", "1*MSE", "1*Super")
    inner_lr: float = 1e-5
    outer_lr: float = 1e-5
    mask_rectify_only: bool = False  # DAIN: both loops on rectifyNet only


def parse_args(preset: LegacyPreset, argv=None) -> argparse.Namespace:
    """The flags of legacy/train_sepconv.py:31-60, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--exp_name", type=str, default="temp")
    p.add_argument("--meta_algorithm", type=str, default="maml",
                   choices=["maml", "reptile"])
    p.add_argument("--batch_size", "--bs", type=int, default=4)
    p.add_argument("--val_batch_size", type=int, default=4)
    p.add_argument("--inner_lr", type=float, default=preset.inner_lr)
    p.add_argument("--outer_lr", type=float, default=preset.outer_lr)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--val_iter", type=int, default=200)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--logfreq", type=int, default=20)
    p.add_argument("--num_inner_update", type=int, default=1)
    p.add_argument("--mode", type=str, default="")
    p.add_argument("--train_iter", type=int, default=4000,
                   help="per-epoch cap (reference hardcodes 4000, :107)")
    p.add_argument("--dataset", type=str, default="vimeo90k")
    p.add_argument("--data_root", type=str, default="data/vimeo_septuplet")
    p.add_argument("--crop_size", type=int, default=128)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoint")
    # tiny-model knobs for tests (ignored by models without them)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--n_resblocks", type=int, default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their "
                        "plain PyTorch versions)")
    return p.parse_args(argv)


def make_outer_optimizer(rule: str, params, lr: float
                         ) -> torch.optim.Optimizer:
    """optax's ``adam(lr)``, ``adamax(lr)`` or ``sgd(lr)`` with their
    defaults: β = (0.9, 0.999), eps 1e-8 outside the square root."""
    params = list(params)
    if rule == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if rule == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8)
    if rule == "SGD":
        return torch.optim.SGD(params, lr=lr)
    raise NotImplementedError(f"outer rule {rule!r}")


def to_device_frames(frames, device) -> torch.Tensor:
    """(B, T, H, W, C) numpy → (B, T, C, H, W) float32 on ``device``."""
    frames = np.asarray(frames, np.float32).transpose(0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(frames)).to(device)


def build(preset: LegacyPreset, cfg: argparse.Namespace):
    """(model, params, loss_fn, mask, device) of a preset: the model from
    seed 0 with its weights as ``params`` ({name: tensor}, views of the
    model's), the loss a scalar function, the mask DAIN's inner one."""
    from ..core import losses as losses_lib
    from ..meta.system import _resolve_device
    from ..models import registry
    device = _resolve_device(cfg.device)
    md = registry.get(preset.model)
    accepted = inspect.signature(md.build).parameters
    kwargs = {k: getattr(cfg, k) for k in ("depth", "n_resblocks")
              if getattr(cfg, k) is not None and k in accepted}
    model = md.build(torch.Generator().manual_seed(0), **kwargs).to(device)
    model.requires_grad_(False)
    params = {k: p.detach() for k, p in model.named_parameters()}
    if preset.model == "dain":
        from ..models.dain.model import charbonnier_loss

        def loss_fn(pred, target, aux=None):
            return charbonnier_loss(pred, target)
    else:
        raw = losses_lib.make_loss_fn(
            preset.loss_spec, generator=torch.Generator().manual_seed(1),
            device=device)

        def loss_fn(pred, target, aux=None):
            return raw(pred, target, aux)["total"]
    mask = None
    if preset.mask_rectify_only and md.inner_mask_fn is not None:
        mask = md.inner_mask_fn(model)
    return md, model, params, loss_fn, mask, device


class _DataCfg:
    """The attributes MetaLearningSystemDataLoader reads."""

    def __init__(self, cfg, model: str):
        self.dataset = cfg.dataset
        self.data_root = cfg.data_root
        self.model = model
        self.mode = "train"
        self.crop_size = cfg.crop_size
        self.test_mode = "hard"
        self.img_fmt = "png"
        self.batch_size = cfg.batch_size
        self.val_batch_size = cfg.val_batch_size
        self.test_batch_size = cfg.val_batch_size
        self.num_workers = 4
        self.random_seed = 0


def run(preset: LegacyPreset, argv=None):
    from ..core import checkpoint as ckpt_lib
    from ..core import metrics as metrics_lib
    from ..data.loader import MetaLearningSystemDataLoader
    from ..utils.meters import AverageMeter
    from . import trainers

    cfg = parse_args(preset, argv)
    md, model, params, loss_fn, mask, device = build(preset, cfg)
    outer_opt = make_outer_optimizer(preset.outer_opt, params.values(),
                                     cfg.outer_lr)
    data = MetaLearningSystemDataLoader(_DataCfg(cfg, preset.model))
    steps = dict(num_steps=cfg.num_inner_update,
                 inner_rule=preset.inner_rule, mask=mask)

    def train_epoch(epoch, params):
        losses = AverageMeter()
        t0 = time.time()
        for i, (frames, _meta) in enumerate(data.get_train_batches(
                total_batches=cfg.train_iter, epoch=epoch)):
            frames = to_device_frames(frames, device)
            if cfg.meta_algorithm == "reptile":
                params, loss = trainers.reptile_step(
                    model, loss_fn, params, frames, cfg.inner_lr,
                    cfg.outer_lr, **steps)
            else:
                params, loss = trainers.fomaml_step(
                    model, loss_fn, params, outer_opt, frames, cfg.inner_lr,
                    **steps)
            losses.update(float(loss))
            if i % cfg.logfreq == 0:
                print(f"Epoch: [{epoch}][{i}]  Loss {losses.val:.4f} "
                      f"({losses.avg:.4f})  {time.time() - t0:.1f}s",
                      flush=True)
        return params

    def validate(epoch, params):
        psnrs, losses = AverageMeter(), AverageMeter()
        cap = 10 ** 9 if cfg.val_iter == -1 else cfg.val_iter
        for i, (frames, _meta) in enumerate(data.get_val_batches()):
            if i >= cap:
                break
            frames = to_device_frames(frames, device)
            loss, pred = trainers.eval_episode(model, loss_fn, params, frames,
                                               cfg.inner_lr, **steps)
            psnr, _ = metrics_lib.calc_metrics(md.denormalize(pred),
                                               md.denormalize(frames[:, 3]))
            psnrs.update(float(psnr))
            losses.update(float(loss))
        print(f"val_losses: {losses.avg:.6f}")
        print(f"val_PSNR: {psnrs.avg:.6f}")
        return psnrs.avg

    if cfg.mode == "test":
        validate(cfg.start_epoch, params)
        return params

    best_psnr = 0.0
    exp_dir = os.path.join(cfg.checkpoint_dir, cfg.exp_name)
    for epoch in range(cfg.start_epoch, cfg.max_epoch):
        params = train_epoch(epoch, params)
        psnr = validate(epoch, params)
        is_best = psnr > best_psnr
        best_psnr = max(psnr, best_psnr)
        ckpt_lib.save_checkpoint(
            {"epoch": epoch + 1, "arch": vars(cfg), "params": params,
             "best_PSNR": best_psnr}, exp_dir, is_best=is_best)
    return params
