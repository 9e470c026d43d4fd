"""Scene-adaptation episodes, first order.

Counterpart of ``meta_interpolation_tpu/meta/episode.py`` (reference
``meta_learning_system.py:346-472``). Where the JAX package compiles a
vmap over tasks and a scan over inner steps, this runs Python loops:

  * tasks        → a loop in :meth:`EpisodeBuilder.batched_episode`;
  * inner steps  → a loop in :meth:`EpisodeBuilder.adapt`, each step one
                   ``torch.autograd.grad`` of the summed support losses
                   w.r.t. detached copies of the adaptable parameters
                   (first order: ``create_graph=False``);
  * support pairs → a loop in :meth:`EpisodeBuilder._support_loss`.

The model runs through ``torch.func.functional_call`` with a dict of
adapted tensors. Inner-frozen parameters are left out of the gradient
list, the counterpart of the JAX ``_prune_frozen``/``_masked`` pair: their
gradients are never computed and they are never updated.

Only evaluation is ported: training episodes (the outer loss and its
gradient, MSL), second order, L2F attenuation and per-step BN raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..core import metrics as metrics_lib
from .inner_optimizers import InnerOptimizer

Params = Dict[str, torch.Tensor]


def per_step_loss_importance(num_steps: int, epoch: int,
                             msl_num_epochs: int) -> np.ndarray:
    """MSL importance vector (reference meta_learning_system.py:186-210)."""
    if num_steps == 0:
        return np.ones((1,), np.float32)
    w = np.ones((num_steps,), np.float32) / num_steps
    decay = 1.0 / num_steps / msl_num_epochs
    min_non_final = 0.03 / num_steps
    for i in range(num_steps - 1):
        w[i] = max(w[i] - epoch * decay, min_non_final)
    w[-1] = min(w[-1] + epoch * (num_steps - 1) * decay,
                1.0 - (num_steps - 1) * min_non_final)
    return w


@dataclasses.dataclass(frozen=True)
class EpisodeSpec:
    support_idxs: Tuple[Tuple[int, int, int], ...] = ((0, 2, 4), (2, 4, 6))
    target_idxs: Tuple[int, int, int] = (2, 3, 4)
    num_steps: int = 1
    second_order: bool = False
    use_msl: bool = False


class EpisodeBuilder:
    """Per-task and batched episodes for one model.

    ``model(f0, f1, **apply_kwargs) -> pred`` on NCHW frames;
    ``loss_fn(pred, target) -> {..., 'total'}``; ``inner_keep``: optional
    {param name: adapted?}; ``apply_kwargs``: passed to every forward.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 inner_opt: InnerOptimizer,
                 denormalize: Callable = lambda x: x,
                 inner_keep: Optional[Dict[str, bool]] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None):
        self.model = model
        self.apply_kwargs = dict(apply_kwargs or {})
        self.loss_fn = loss_fn
        self.inner_opt = inner_opt
        self.denormalize = denormalize
        self.inner_keep = inner_keep

    def _pair_loss(self, params: Params, f0, f1, target):
        """One criterion call → (loss_total, pred); frames are CHW."""
        pred = functional_call(self.model, params, (f0[None], f1[None]),
                               self.apply_kwargs)
        return self.loss_fn(pred, target[None])["total"], pred[0]

    def _support_loss(self, params: Params, frames, spec: EpisodeSpec):
        total = 0.0
        for i0, it, i1 in spec.support_idxs:
            loss, _ = self._pair_loss(params, frames[i0], frames[i1],
                                      frames[it])
            total = total + loss
        return total

    def adapt(self, net_params: Params, lrs: Params, frames: torch.Tensor,
              spec: EpisodeSpec) -> Params:
        """Inner-loop adaptation on one task; frames (T, C, H, W).
        Returns the adapted parameters (inner-frozen ones unchanged)."""
        if spec.second_order:
            raise NotImplementedError(
                "second-order adaptation is not ported to PyTorch yet")
        live = [k for k in net_params
                if self.inner_keep is None or self.inner_keep[k]]
        params = {k: v.detach() for k, v in net_params.items()}
        state = self.inner_opt.init_state({k: params[k] for k in live})
        for step in range(spec.num_steps):
            src = {k: params[k].requires_grad_(True) for k in live}
            loss = self._support_loss({**params, **src}, frames, spec)
            grads = torch.autograd.grad(loss, [src[k] for k in live])
            with torch.no_grad():
                new, state = self.inner_opt.update(
                    {k: src[k].detach() for k in live},
                    dict(zip(live, grads)), lrs, state, step)
            params.update(new)
        return params

    def task_episode(self, meta_params: Dict[str, Params],
                     frames: torch.Tensor, msl_weights, spec: EpisodeSpec,
                     training: bool = False):
        """Full episode on one task → (outer_loss, pred, query_loss); in
        evaluation the outer loss is the post-adaptation query loss."""
        if training:
            raise NotImplementedError("training is a later slice")
        adapted = self.adapt(meta_params["net"], meta_params["lrs"], frames,
                             spec)
        q0, qt, q1 = spec.target_idxs
        with torch.no_grad():
            q_loss, pred = self._pair_loss(adapted, frames[q0], frames[q1],
                                           frames[qt])
        return q_loss, pred, q_loss

    def batched_episode(self, meta_params: Dict[str, Params],
                        frames: torch.Tensor, msl_weights, spec: EpisodeSpec,
                        training: bool = False, with_metrics: bool = False):
        """Loop over tasks; frames (B, T, C, H, W). Returns (mean outer
        loss, aux) with aux['preds'] (B, C, H, W), aux['query_loss'] and,
        ``with_metrics``, the task-mean aux['psnr'] / aux['ssim']."""
        outer, preds, q_losses = [], [], []
        for task in frames:
            o, pred, q = self.task_episode(meta_params, task, msl_weights,
                                           spec, training=training)
            outer.append(o)
            preds.append(pred)
            q_losses.append(q)
        preds = torch.stack(preds)
        aux = {"preds": preds, "query_loss": torch.stack(q_losses).mean()}
        if with_metrics:
            qt = spec.target_idxs[1]
            dn_pred = self.denormalize(preds)
            dn_tgt = self.denormalize(frames[:, qt])
            psnr, ssim = zip(*(metrics_lib.calc_metrics(p, t)
                               for p, t in zip(dn_pred, dn_tgt)))
            aux["psnr"] = torch.stack(psnr).mean()
            aux["ssim"] = torch.stack(ssim).mean()
        return torch.stack(outer).mean(), aux
