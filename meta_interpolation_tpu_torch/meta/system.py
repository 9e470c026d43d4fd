"""SceneAdaptiveInterpolation — the user-facing meta-learning system.

Counterpart of ``meta_interpolation_tpu/meta/system.py`` (reference
``meta_learning_system.py:29-697``): holds the model, the meta-parameters
(net weights + inner learning rates), the inner rule, the inner mask and
the loss, and drives scene-adaptive evaluation through
:meth:`run_validation_iter`. Training is a later slice.
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
        ("--fix_loaded", cfg.fix_loaded),
        ("--dtype bfloat16", cfg.dtype != "float32"),
        ("--spatial_shards", cfg.spatial_shards > 1),
    ] if on]


class SceneAdaptiveInterpolation:
    """Meta-learning system: build with a Config, drive with run_*_iter."""

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None):
        unported = _unported(cfg)
        if unported:
            raise NotImplementedError(
                f"not ported to PyTorch yet: {', '.join(unported)}")
        self.cfg = cfg
        self.device = _resolve_device(device or cfg.device)
        # before any backward: the forwards set it too, but a backward's
        # convolutions read the flags when they run
        layers.full_float32()

        self.model_def = registry.get(cfg.model)
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
        net = {k: p.detach() for k, p in self.model.named_parameters()}
        self.meta_params: Dict[str, Dict[str, torch.Tensor]] = {
            "net": net, "lrs": self.inner_opt.init_lrs(net, cfg.inner_lr)}
        inner_keep = (self.model_def.inner_mask_fn(self.model)
                      if self.model_def.inner_mask_fn is not None else None)
        self.loss_fn = (self.model_def.loss_fn
                        or losses_lib.make_loss_fn(cfg.loss))
        self.builder = episode_lib.EpisodeBuilder(
            self.model, self.loss_fn, self.inner_opt,
            denormalize=self.model_def.denormalize, inner_keep=inner_keep,
            apply_kwargs=self.model_def.meta_apply_kwargs)
        self.current_epoch = 0

    def load_net(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a state dict of net weights (names as the model's)."""
        self.model.load_state_dict(state)
        self.meta_params["net"] = {
            k: p.detach() for k, p in self.model.named_parameters()}

    def _frames(self, frames) -> torch.Tensor:
        """(B, T, H, W, C) numpy/tensor → (B, T, C, H, W) on the device."""
        frames = np.asarray(frames, np.float32).transpose(0, 1, 4, 2, 3)
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def run_train_iter(self, frames, epoch: int, do_evaluation: bool = False):
        raise NotImplementedError("training is a later slice")

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
