"""SceneAdaptiveInterpolation — the user-facing meta-learning system.

Counterpart of ``meta_interpolation_tpu/meta/system.py`` (reference
``meta_learning_system.py:29-697``): holds the model, the meta-parameters
(net weights + inner learning rates), the inner rule, the inner mask and
the loss, the outer optimizer and its plateau schedule, and drives
meta-training (:meth:`run_train_iter`, first or second order, with MSL),
scene-adaptive evaluation (:meth:`run_validation_iter`) and ×2 slow
motion (:meth:`run_test_iter`), for all six backbones.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..core import losses as losses_lib
from ..models import layers, registry
from . import episode as episode_lib
from .inner_optimizers import make_inner_optimizer


class PlateauScheduler:
    """ReduceLROnPlateau(mode='min', factor=0.2, patience=5), the JAX
    package's copy of torch's semantics (JAX meta/system.py:28-64):
    relative threshold 1e-4 (an epoch improves only when ``metric <
    best·(1 − threshold)``), and the rate decays when the bad-epoch count
    exceeds ``patience``."""

    def __init__(self, init_lr: float, factor: float = 0.2, patience: int = 5,
                 threshold: float = 1e-4):
        self.lr = init_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = np.inf
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if (not np.isfinite(self.best)
                or metric < self.best * (1.0 - self.threshold)):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
                print(f"PlateauScheduler: reducing outer lr to {self.lr:.3e}")
        return self.lr


def make_outer_optimizer(rule: str, params, lr: float
                         ) -> torch.optim.Optimizer:
    """The outer rule of JAX ``make_outer_optimizer`` (meta/system.py
    :66-117) over ``params``: Adam with β = (0.9, 0.99) and eps 1e-8,
    Adamax with β = (0.9, 0.999) and eps 1e-8 (torch's, like
    ``optax.scale_by_adamax``, keeps ``max(β2·u, |g| + eps)``), or SGD.
    ``params`` may be parameter groups (``ModelDef.outer_groups``), each
    with its own options and an ``lr_scale``: its rate is ``lr_scale``
    times ``lr``."""
    params = list(params)
    if params and isinstance(params[0], dict):
        params = [{**group, "lr": lr * group["lr_scale"]}
                  for group in params]
    if rule == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-8,
                                foreach=True)
    if rule == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999),
                                  eps=1e-8, foreach=True)
    if rule == "SGD":
        return torch.optim.SGD(params, lr=lr, foreach=True)
    raise NotImplementedError(f"outer rule {rule!r}")


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but no CUDA device is available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")
    return device


def _unported(cfg: Config):
    """Flags whose behaviour the port does not have yet."""
    return [flag for flag, on in [
        ("--attenuate", cfg.attenuate),
        ("--per_step_bn_statistics", cfg.per_step_bn_statistics),
        ("--dtype bfloat16", cfg.dtype != "float32"),
        ("--spatial_shards", cfg.spatial_shards > 1),
    ] if on]


def _adapt_bn_affine(inner_keep: Dict[str, bool]) -> Dict[str, bool]:
    """--enable_inner_loop_optimizable_bn_params (JAX meta/system.py
    :206-220): the scale and bias of every batch norm (a module named
    ``*_bn``) adapt in the inner loop too. Its statistics are buffers and
    stay frozen."""
    def in_bn_affine(name: str) -> bool:
        *parents, leaf = name.split(".")
        return (leaf in ("weight", "bias")
                and any(p.endswith("_bn") for p in parents))
    return {k: keep or in_bn_affine(k) for k, keep in inner_keep.items()}


class SceneAdaptiveInterpolation:
    """Meta-learning system: build with a Config, drive with run_*_iter."""

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None):
        unported = _unported(cfg)
        if unported:
            raise NotImplementedError(
                f"not ported to PyTorch yet: {', '.join(unported)}")
        self.cfg = cfg
        self.model_def = registry.get(cfg.model)
        if cfg.mode == "train" or cfg.second_order:
            self._refuse_untrainable()
        self.device = _resolve_device(device or cfg.device)
        # before any backward: the forwards set it too, but a backward's
        # convolutions read the flags when they run
        layers.full_float32()

        # model hyperparameters from the CLI (JAX meta/system.py:133-149)
        self.model_kwargs = self.model_def.build_kwargs(cfg)
        gen = torch.Generator().manual_seed(cfg.random_seed)
        self.model = self.model_def.build(gen, **self.model_kwargs).to(
            self.device)
        # weights flow through functional_call as meta_params['net']
        self.model.requires_grad_(False)
        self.inner_opt = make_inner_optimizer(cfg)
        if (self.inner_opt.lr_mode == "lslr"
                and cfg.num_eval_steps > cfg.num_inner_steps + 1):
            raise ValueError(
                f"number_of_evaluation_steps_per_iter "
                f"({cfg.num_eval_steps}) exceeds the per-step LSLR "
                f"learning-rate slots ({cfg.num_inner_steps + 1}); raise "
                f"number_of_training_steps_per_iter or use --metasgd")
        # views of the model's parameters: loading weights into the model
        # loads them here; the outer optimizer updates them in place
        net = {k: p.detach() for k, p in self.model.named_parameters()}
        self.meta_params: Dict[str, Dict[str, torch.Tensor]] = {
            "net": net, "lrs": self.inner_opt.init_lrs(net, cfg.inner_lr)}
        inner_keep = (self.model_def.inner_mask_fn(self.model)
                      if self.model_def.inner_mask_fn is not None else None)
        if inner_keep is not None and \
                cfg.enable_inner_loop_optimizable_bn_params:
            inner_keep = _adapt_bn_affine(inner_keep)
        # the loss's own weights (the Super term's VGG16) from another
        # stream than the model's
        self.loss_fn = (self.model_def.loss_fn or losses_lib.make_loss_fn(
            cfg.loss, generator=torch.Generator().manual_seed(
                cfg.random_seed + 1), device=self.device))
        self.builder = episode_lib.EpisodeBuilder(
            self.model, self.loss_fn, self.inner_opt,
            denormalize=self.model_def.denormalize, inner_keep=inner_keep,
            apply_kwargs=self.model_def.meta_apply_kwargs,
            returns_aux=self.model_def.returns_aux)
        # outer trainability: the model's outer mask (DAIN: rectifyNet
        # only), the rates when learnable. A leaf that trains in neither
        # loop gets requires_grad False in outer_grads, which keeps it off
        # the tape in second order too (JAX builder.outer_keep)
        outer_keep = (self.model_def.outer_mask_fn(self.model)
                      if self.model_def.outer_mask_fn is not None
                      else {k: True for k in net})
        self.trainable = {"net": dict(outer_keep),
                          "lrs": {k: self.inner_opt.learnable for k in net}}
        if cfg.use_multi_step_loss_optimization and cfg.num_inner_steps == 0:
            raise ValueError(
                "--use_multi_step_loss_optimization requires "
                "number_of_training_steps_per_iter >= 1")
        groups = (self.model_def.outer_groups(cfg, self.meta_params)
                  if self.model_def.outer_groups is not None else None)
        self.outer_opt = make_outer_optimizer(
            cfg.optimizer, groups or [v for tree in self.meta_params.values()
                                      for v in tree.values()], cfg.outer_lr)
        self.scheduler = PlateauScheduler(cfg.outer_lr)
        self.current_epoch = 0

    def freeze_loaded(self, loaded: Dict[str, bool]) -> None:
        """--fix_loaded (JAX meta/system.py:325-346): the net tensors that
        were loaded from a checkpoint train in neither loop."""
        self.trainable["net"] = {k: t and not loaded[k]
                                 for k, t in self.trainable["net"].items()}
        inner = self.builder.inner_keep or {k: True for k in loaded}
        self.builder.inner_keep = {k: inner[k] and not loaded[k]
                                   for k in inner}

    def load_net(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a state dict of net weights (names as the model's) into the
        model, and so into ``meta_params['net']``, its views."""
        self.model.load_state_dict(state)

    def _refuse_untrainable(self):
        if not self.model_def.trainable:
            raise NotImplementedError(
                f"meta-training (--mode train, --second_order) of "
                f"{self.cfg.model!r} is not ported to PyTorch yet")

    def _frames(self, frames) -> torch.Tensor:
        """(B, T, H, W, C) numpy/tensor → (B, T, C, H, W) on the device."""
        frames = np.asarray(frames, np.float32).transpose(0, 1, 4, 2, 3)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _use_second_order(self, epoch: int) -> bool:
        return (self.cfg.second_order
                and epoch > self.cfg.first_order_to_second_order_epoch)

    def _msl_active(self, epoch: int) -> bool:
        return (self.cfg.use_multi_step_loss_optimization
                and epoch < self.cfg.multi_step_loss_num_epochs)

    def outer_grads(self, frames, epoch: int, with_metrics: bool = False):
        """The outer loss and its gradient at the meta-parameters, before
        the optimizer (JAX ``train_step``'s ``value_and_grad``, :449-462).
        Returns (loss, aux, grads): aux as ``batched_episode``'s, ``grads``
        like ``meta_params``, zero where the trainable mask is off."""
        self._refuse_untrainable()
        spec = episode_lib.EpisodeSpec(
            support_idxs=self.cfg.support_idxs("train"),
            target_idxs=self.cfg.target_idxs,
            num_steps=self.cfg.num_inner_steps,
            second_order=self._use_second_order(epoch),
            use_msl=self._msl_active(epoch))
        msl_w = episode_lib.per_step_loss_importance(
            self.cfg.num_inner_steps, epoch,
            self.cfg.multi_step_loss_num_epochs)
        leaves = {g: {k: v.detach().requires_grad_(self.trainable[g][k])
                      for k, v in tree.items()}
                  for g, tree in self.meta_params.items()}
        loss, aux = self.builder.batched_episode(
            leaves, self._frames(frames), msl_w, spec, training=True,
            with_metrics=with_metrics)
        grads = {g: {k: (v.grad if v.grad is not None
                         else torch.zeros_like(v))
                     for k, v in tree.items()}
                 for g, tree in leaves.items()}
        return loss, aux, grads

    def run_train_iter(self, frames, epoch: int, do_evaluation: bool = False):
        """One outer update (JAX :487-570, without the adversarial and
        per-step BN branches). frames: (B, T, H, W, C) in model input
        space. A tensor the trainable mask leaves off gets no gradient, so
        the optimizer neither updates it nor keeps moments for it. Returns
        (losses with PSNR/SSIM when ``do_evaluation``, preds (B, C, H, W))."""
        self.current_epoch = int(epoch)
        loss, aux, grads = self.outer_grads(frames, epoch, do_evaluation)
        for g, tree in self.meta_params.items():
            for k, v in tree.items():
                v.grad = grads[g][k] if self.trainable[g][k] else None
        self.outer_opt.step()
        self.outer_opt.zero_grad(set_to_none=True)
        losses = {"loss": float(loss), "total": float(aux["query_loss"])}
        if do_evaluation:
            losses["psnr"] = float(aux["psnr"])
            losses["ssim"] = float(aux["ssim"])
        return losses, aux["preds"]

    def run_validation_iter(self, frames):
        """Eval episode: adapt with grads, query under no-grad (reference
        :608-627). frames: (B, T, H, W, C) in model input space. Returns
        (losses, preds) with preds (B, C, H, W) on the device."""
        spec = episode_lib.EpisodeSpec(
            support_idxs=self.cfg.support_idxs("train"),
            target_idxs=self.cfg.target_idxs,
            num_steps=self.cfg.num_eval_steps, second_order=False,
            use_msl=True)
        msl_w = episode_lib.per_step_loss_importance(
            self.cfg.num_eval_steps, self.current_epoch,
            self.cfg.multi_step_loss_num_epochs)
        loss, aux = self.builder.batched_episode(
            self.meta_params, self._frames(frames), msl_w, spec,
            training=False, with_metrics=True)
        losses = {"loss": float(loss), "total": float(aux["query_loss"]),
                  "psnr": float(aux["psnr"]), "ssim": float(aux["ssim"])}
        return losses, aux["preds"]

    def run_test_iter(self, frames) -> torch.Tensor:
        """×2 slow motion on 4 consecutive frames (reference :630-697):
        adapt for ``num_eval_steps`` on the support (0, 1, 2) and (1, 2,
        3), then synthesize the midpoint of frames 1 and 2. frames (B, 4,
        H, W, C) in model input space → preds (B, C, H, W) on the device.
        First order whatever --second_order says (JAX passes it on):
        nothing differentiates the adapted weights, so the order changes
        no value."""
        spec = episode_lib.EpisodeSpec(
            support_idxs=self.cfg.support_idxs("test"),
            target_idxs=self.cfg.target_idxs,
            num_steps=self.cfg.num_eval_steps)
        return self.builder.test_episode(self.meta_params,
                                         self._frames(frames), spec)

    def epoch_end(self, val_loss: float):
        """The plateau schedule, once an epoch on the validation loss; the
        new rate goes into the optimizer, as JAX injects it, each group's
        scaled by its ``lr_scale`` (VoxelFlow's conv biases keep their ×2,
        as JAX's ``scale(2.0)`` after the injected rate does)."""
        lr = self.scheduler.step(val_loss)
        for group in self.outer_opt.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)

    def state_dict(self) -> dict:
        """Meta-parameters, outer-optimizer state, epoch and the schedule's
        state (without it a resume would reset a decayed rate)."""
        return {"meta_params": self.meta_params,
                "opt_state": self.outer_opt.state_dict(),
                "epoch": self.current_epoch,
                "scheduler": {"lr": self.scheduler.lr,
                              "best": self.scheduler.best,
                              "bad_epochs": self.scheduler.bad_epochs}}

    def load_state_dict(self, state: dict):
        """Resume from a :meth:`state_dict`: the meta-parameters are copied
        into the system's own tensors (on its device), which the outer
        optimizer holds; then its state, the epoch and the schedule."""
        with torch.no_grad():
            for g, tree in state["meta_params"].items():
                for k, v in tree.items():
                    self.meta_params[g][k].copy_(v)
        self.outer_opt.load_state_dict(state["opt_state"])
        self.current_epoch = int(state["epoch"])
        sched = state["scheduler"]
        self.scheduler.lr = float(sched["lr"])
        self.scheduler.best = float(sched["best"])
        self.scheduler.bad_epochs = int(sched["bad_epochs"])
