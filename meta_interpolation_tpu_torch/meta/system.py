"""SceneAdaptiveInterpolation — the user-facing meta-learning system.

Counterpart of ``meta_interpolation_tpu/meta/system.py`` (reference
``meta_learning_system.py:29-697``): holds the model, the meta-parameters
(net weights + inner learning rates), the inner rule, the inner mask and
the loss, the outer optimizer and its plateau schedule, and drives
meta-training (:meth:`run_train_iter`, first or second order, with MSL),
scene-adaptive evaluation (:meth:`run_validation_iter`) and ×2 slow
motion (:meth:`run_test_iter`), for all six backbones.

Beside ``net`` and ``lrs`` the meta-parameters may hold three more
groups, as the JAX system's do: ``attenuator`` (L2F, ``--attenuate``;
outer-trained), ``bn_state`` (per-step BN statistics,
``--per_step_bn_statistics``; written back after each train iteration,
never by the optimizer) and ``loss_ctx`` (the adversarial loss's
discriminator, trained by its own Adam after the outer step).
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..core import adversarial
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
        ("--spatial_shards", cfg.spatial_shards > 1),
    ] if on]


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if cfg.attenuate and cfg.per_step_bn_statistics:
            # the JAX episode's attenuation forward passes no BN state
            # (meta/episode.py:330), so JAX runs no such episode to hold
            # the port to
            raise NotImplementedError(
                "--attenuate with --per_step_bn_statistics: no JAX episode "
                "runs the two together")
        if cfg.dtype not in DTYPES:
            raise ValueError(f"--dtype takes {tuple(DTYPES)}, got "
                             f"{cfg.dtype!r}")
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
        # outer trainability: the model's outer mask (DAIN: rectifyNet
        # only), the rates when learnable. A leaf that trains in neither
        # loop gets requires_grad False in outer_grads, which keeps it off
        # the tape in second order too (JAX builder.outer_keep)
        outer_keep = (self.model_def.outer_mask_fn(self.model)
                      if self.model_def.outer_mask_fn is not None
                      else {k: True for k in net})
        self.trainable = {"net": dict(outer_keep),
                          "lrs": {k: self.inner_opt.learnable for k in net}}
        # the loss's weights, the attenuator and the discriminator each
        # from a stream of their own
        seeds = {name: torch.Generator().manual_seed(cfg.random_seed + i)
                 for i, name in enumerate(("loss", "attenuator", "disc"), 1)}
        att_keep = None
        if cfg.attenuate:
            # the attenuator embeds and scales the outer-trained tensors,
            # the reference's names_weights_copy (JAX meta/system.py
            # :186-200; DAIN: rectifyNet only)
            if self.model_def.outer_mask_fn is not None:
                att_keep = dict(outer_keep)
            self.meta_params["attenuator"] = episode_lib.init_attenuator(
                sum(att_keep.values()) if att_keep else len(net),
                seeds["attenuator"], self.device)
        # the adversarial loss's discriminator: its parameters ride in
        # meta_params['loss_ctx'], its own Adam trains them (JAX :223-235)
        patch = min(cfg.crop_size, 96)
        gan_terms = [t for t in losses_lib.parse_loss_spec(cfg.loss)
                     if "GAN" in t.loss_type]
        self.adv_state = None
        if gan_terms:
            self.adv_state = adversarial.AdversarialState(
                gan_terms[0].loss_type, patch, seeds["disc"], self.device)
            self.meta_params["loss_ctx"] = self.adv_state.params
        self._disc_iter = 0
        self.loss_fn = (self.model_def.loss_fn or losses_lib.make_loss_fn(
            cfg.loss, generator=seeds["loss"], device=self.device,
            patch_size=patch))
        self.builder = episode_lib.EpisodeBuilder(
            self.model, self.loss_fn, self.inner_opt,
            denormalize=self.model_def.denormalize, inner_keep=inner_keep,
            apply_kwargs=self.model_def.meta_apply_kwargs,
            returns_aux=self.model_def.returns_aux)
        self.builder.uses_loss_ctx = self.adv_state is not None
        # --dtype bfloat16: the model's forwards in bf16, everything else
        # (meta-parameters, rates, optimizer state, loss) float32
        self.builder.dtype = DTYPES[cfg.dtype]
        # --remat: every forward recomputed in its backward
        self.builder.remat = cfg.remat
        self.builder.att_keep = att_keep
        if cfg.per_step_bn_statistics:
            # per-step BN running statistics (JAX :260-277), threaded
            # through every forward of an episode
            if self.model_def.bn_state_init_fn is None:
                raise ValueError(
                    f"--per_step_bn_statistics: model {cfg.model!r} has no "
                    f"per-step BN support (ModelDef.bn_state_init_fn)")
            if cfg.num_inner_steps < 1:
                raise ValueError(
                    "--per_step_bn_statistics requires "
                    "number_of_training_steps_per_iter >= 1")
            self.meta_params["bn_state"] = self.model_def.bn_state_init_fn(
                cfg.num_inner_steps, self.device)
            self.builder.passes_bn_state = True
        # the attenuator trains; the statistics and the discriminator
        # never take the outer optimizer (JAX _build_trainable_mask)
        for group, on in (("attenuator", True), ("loss_ctx", False),
                          ("bn_state", False)):
            if group in self.meta_params:
                self.trainable[group] = dict.fromkeys(
                    self.meta_params[group], on)
        if cfg.use_multi_step_loss_optimization and cfg.num_inner_steps == 0:
            raise ValueError(
                "--use_multi_step_loss_optimization requires "
                "number_of_training_steps_per_iter >= 1")
        groups = (self.model_def.outer_groups(cfg, self.meta_params)
                  if self.model_def.outer_groups is not None else None)
        self.outer_opt = make_outer_optimizer(
            cfg.optimizer, groups or [
                v for g in ("net", "lrs", "attenuator")
                for v in self.meta_params.get(g, {}).values()],
            cfg.outer_lr)
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

    def _spec(self, mode: str, num_steps: int, second_order: bool = False,
              use_msl: bool = False, collect: bool = False
              ) -> episode_lib.EpisodeSpec:
        """The episode of a mode (JAX ``_episode_spec``); ``collect`` keeps
        the predictions of the --disc_per_forward replay, the MSL query
        ones while MSL is on."""
        return episode_lib.EpisodeSpec(
            support_idxs=self.cfg.support_idxs(mode),
            target_idxs=self.cfg.target_idxs, num_steps=num_steps,
            second_order=second_order, use_msl=use_msl,
            attenuate=self.cfg.attenuate, collect_support_preds=collect,
            collect_query_preds=collect and use_msl)

    def outer_grads(self, frames, epoch: int, with_metrics: bool = False):
        """The outer loss and its gradient at the meta-parameters, before
        the optimizer (JAX ``train_step``'s ``value_and_grad``, :449-462).
        Returns (loss, aux, grads): aux as ``batched_episode``'s, ``grads``
        like ``meta_params``, zero where the trainable mask is off. Under
        --disc_per_forward aux also holds the replay's predictions."""
        self._refuse_untrainable()
        spec = self._spec(
            "train", self.cfg.num_inner_steps, self._use_second_order(epoch),
            self._msl_active(epoch),
            collect=(self.adv_state is not None and self.cfg.disc_per_forward
                     and self.cfg.num_inner_steps > 0))
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
        """One outer update (JAX :487-570). frames: (B, T, H, W, C) in model
        input space. A tensor the trainable mask leaves off gets no
        gradient, so the optimizer neither updates it nor keeps moments for
        it. Then the per-step BN statistics of the iteration are written
        back, and the discriminator takes its step(s). Returns (losses with
        PSNR/SSIM when ``do_evaluation``, preds (B, C, H, W))."""
        self.current_epoch = int(epoch)
        loss, aux, grads = self.outer_grads(frames, epoch, do_evaluation)
        for g, tree in self.meta_params.items():
            for k, v in tree.items():
                v.grad = grads[g][k] if self.trainable[g][k] else None
        self.outer_opt.step()
        self.outer_opt.zero_grad(set_to_none=True)
        if "bn_state" in aux:
            with torch.no_grad():
                for k, v in self.meta_params["bn_state"].items():
                    v.copy_(aux["bn_state"][k])
        if self.adv_state is not None:
            self._discriminator_step(aux, self._frames(frames), epoch)
        losses = {"loss": float(loss), "total": float(aux["query_loss"])}
        if do_evaluation:
            losses["psnr"] = float(aux["psnr"])
            losses["ssim"] = float(aux["ssim"])
        return losses, aux["preds"]

    def _discriminator_step(self, aux, frames: torch.Tensor, epoch: int):
        """The discriminator's update(s) after the outer step (JAX
        :513-565). All of the iteration's generator terms saw the
        discriminator as it was before, as in JAX (the reference updates it
        inside every criterion call). Default cadence: one update on the B
        query predictions against their targets. --disc_per_forward: the
        reference's B·(S·P + Sq + 1) single-item updates in its order
        (``adversarial.build_replay_sequence``). WGAN-GP's interpolation
        weights come from the iteration's own stream
        (``adversarial.eps_generator``)."""
        qt = self.cfg.target_idxs[1]
        self._disc_iter += 1
        gen = adversarial.eps_generator(epoch, self._disc_iter)
        if "support_preds" in aux:
            fakes, reals = adversarial.build_replay_sequence(
                aux["support_preds"], aux.get("query_preds"), aux["preds"],
                frames, [it for _, it, _ in self.cfg.support_idxs("train")],
                qt)
            self.adv_state.replay(fakes, reals, generator=gen)
        else:
            self.adv_state.update_discriminator(aux["preds"], frames[:, qt],
                                                generator=gen)

    def run_validation_iter(self, frames):
        """Eval episode: adapt with grads, query under no-grad (reference
        :608-627). frames: (B, T, H, W, C) in model input space. Returns
        (losses, preds) with preds (B, C, H, W) on the device."""
        spec = self._spec("train", self.cfg.num_eval_steps, use_msl=True)
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
        spec = self._spec("test", self.cfg.num_eval_steps)
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
        """Meta-parameters (every group: the attenuator, the BN statistics
        and the discriminator too), outer-optimizer state, epoch and the
        schedule's state (without it a resume would reset a decayed
        rate). The discriminator's Adam state is not kept, as in JAX's
        (:612-619)."""
        return {"meta_params": self.meta_params,
                "opt_state": self.outer_opt.state_dict(),
                "epoch": self.current_epoch,
                "scheduler": {"lr": self.scheduler.lr,
                              "best": self.scheduler.best,
                              "bad_epochs": self.scheduler.bad_epochs}}

    def load_state_dict(self, state: dict):
        """Resume from a :meth:`state_dict`: the meta-parameters are copied
        into the system's own tensors (on its device), which the outer
        optimizer (and the discriminator's) holds; then its state, the
        epoch and the schedule. The discriminator's Adam starts afresh."""
        with torch.no_grad():
            for g, tree in state["meta_params"].items():
                for k, v in tree.items():
                    self.meta_params[g][k].copy_(v)
        self.outer_opt.load_state_dict(state["opt_state"])
        if self.adv_state is not None:
            self.adv_state.opt = self.adv_state.make_optimizer()
        self.current_epoch = int(state["epoch"])
        sched = state["scheduler"]
        self.scheduler.lr = float(sched["lr"])
        self.scheduler.best = float(sched["best"])
        self.scheduler.bad_epochs = int(sched["bad_epochs"])
