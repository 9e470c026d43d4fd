"""Scene-adaptation episodes: evaluation, ×2 slow motion and
meta-training, first and second order.

Counterpart of ``meta_interpolation_tpu/meta/episode.py`` (reference
``meta_learning_system.py:346-472``). Where the JAX package compiles a
vmap over tasks and a scan over inner steps, this runs Python loops:

  * tasks        → a loop in :meth:`EpisodeBuilder.batched_episode`, in
                   training one backward a task;
  * inner steps  → a loop in :meth:`EpisodeBuilder.adapt`, each step one
                   ``torch.autograd.grad`` of the summed support losses;
  * support pairs → a loop in :meth:`EpisodeBuilder._support_loss`.

The model runs through ``torch.func.functional_call`` with a dict of
adapted tensors. Inner-frozen parameters are left out of the gradient
list, the counterpart of the JAX ``_prune_frozen``/``_masked`` pair: their
inner gradients are never computed and they are never updated.

First order takes each support gradient on detached copies
(``create_graph=False``); second order takes it on the live parameters
with ``create_graph=True``, while the inner-frozen ones stay the outer
leaves, so the cross term d(inner grad)/d(frozen leaf) reaches their
outer gradient. A leaf frozen in both loops (DAIN's every subnet but
rectifyNet) takes no gradient in the system's ``outer_grads``, so it is
off the tape in either order (JAX ``builder.outer_keep``). In training the
update ``θ − lr·step`` is on the tape either way. Models that return aux
(SuperSloMo) hand it to the loss in every pass, training included. L2F
attenuation and per-step BN raise ``NotImplementedError``.
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

    ``model(f0, f1, **apply_kwargs) -> pred`` on NCHW frames, or ``(pred,
    aux)`` when ``returns_aux`` (SuperSloMo); ``loss_fn(pred, target, aux)
    -> {..., 'total'}``, aux None unless the model returns one;
    ``inner_keep``: optional {param name: adapted?}; ``apply_kwargs``:
    passed to every forward.
    """

    def __init__(self, model: nn.Module, loss_fn: Callable,
                 inner_opt: InnerOptimizer,
                 denormalize: Callable = lambda x: x,
                 inner_keep: Optional[Dict[str, bool]] = None,
                 apply_kwargs: Optional[Dict[str, Any]] = None,
                 returns_aux: bool = False):
        self.model = model
        self.apply_kwargs = dict(apply_kwargs or {})
        self.loss_fn = loss_fn
        self.inner_opt = inner_opt
        self.denormalize = denormalize
        self.inner_keep = inner_keep
        self.returns_aux = returns_aux

    def _pair_loss(self, params: Params, f0, f1, target):
        """One criterion call → (loss_total, pred); frames are CHW. A
        model's aux gains the unpadded inputs ``I0``, ``I1`` (batch 1), as
        JAX ``_pair_loss`` adds them (``meta/episode.py:239-261``)."""
        out = functional_call(self.model, params, (f0[None], f1[None]),
                              self.apply_kwargs)
        aux = None
        if self.returns_aux:
            out, aux = out
            aux = {**aux, "I0": f0[None], "I1": f1[None]}
        return self.loss_fn(out, target[None], aux)["total"], out[0]

    def _support_loss(self, params: Params, frames, spec: EpisodeSpec):
        total = 0.0
        for i0, it, i1 in spec.support_idxs:
            loss, _ = self._pair_loss(params, frames[i0], frames[i1],
                                      frames[it])
            total = total + loss
        return total

    def adapt(self, net_params: Params, lrs: Params, frames: torch.Tensor,
              spec: EpisodeSpec, msl_losses: Optional[list] = None
              ) -> Params:
        """Inner-loop adaptation on one task; frames (T, C, H, W).

        Returns the adapted parameters (inner-frozen ones unchanged); given
        ``msl_losses``, appends to it the query loss after each of steps
        0..n−2 (MSL). The update is recorded on the tape wherever
        ``net_params`` or ``lrs`` require grad; the support gradient is on
        detached copies unless ``spec.second_order``."""
        live = [k for k in net_params
                if self.inner_keep is None or self.inner_keep[k]]
        params = dict(net_params)
        state = self.inner_opt.init_state(
            {k: params[k].detach() for k in live})
        q0, qt, q1 = spec.target_idxs
        for step in range(spec.num_steps):
            if spec.second_order:
                loss = self._support_loss(params, frames, spec)
                grads = torch.autograd.grad(
                    loss, [params[k] for k in live], create_graph=True)
            else:
                src = {k: v.detach() for k, v in params.items()}
                for k in live:
                    src[k].requires_grad_(True)
                loss = self._support_loss(src, frames, spec)
                grads = torch.autograd.grad(loss, [src[k] for k in live])
            new, state = self.inner_opt.update(
                {k: params[k] for k in live}, dict(zip(live, grads)), lrs,
                state, step)
            params.update(new)
            if msl_losses is not None and step < spec.num_steps - 1:
                msl_losses.append(self._pair_loss(
                    params, frames[q0], frames[q1], frames[qt])[0])
        return params

    def task_episode(self, meta_params: Dict[str, Params],
                     frames: torch.Tensor, msl_weights, spec: EpisodeSpec,
                     training: bool = False):
        """Full episode on one task → (outer_loss, pred, query_loss), the
        prediction and query loss detached. Training keeps the outer loss
        on the tape: under MSL the weighted query losses of steps 0..n−2
        plus the last weight times the final query loss (JAX
        ``task_episode``, :524-581). In evaluation the query runs under
        no-grad and the outer loss is the query loss."""
        msl = training and spec.use_msl and spec.num_steps > 0
        step_losses = [] if msl else None
        adapted = self.adapt(meta_params["net"], meta_params["lrs"], frames,
                             spec, msl_losses=step_losses)
        q0, qt, q1 = spec.target_idxs
        with torch.set_grad_enabled(training):
            q_loss, pred = self._pair_loss(adapted, frames[q0], frames[q1],
                                           frames[qt])
        outer = q_loss
        if msl:
            n = spec.num_steps
            outer = float(msl_weights[n - 1]) * q_loss
            for w, loss in zip(msl_weights[:n - 1], step_losses):
                outer = outer + float(w) * loss
        return outer, pred.detach(), q_loss.detach()

    def test_episode(self, meta_params: Dict[str, Params],
                     frames: torch.Tensor, spec: EpisodeSpec
                     ) -> torch.Tensor:
        """×2 slow motion (JAX ``test_episode``, reference run_test_iter
        :630-697): for each task of 4 consecutive frames, adapt on
        ``spec.support_idxs`` ((0, 1, 2) and (1, 2, 3)), then synthesize the
        midpoint of frames 1 and 2 under no-grad. frames (B, 4, C, H, W) →
        (B, C, H, W)."""
        preds = []
        for task in frames:
            adapted = self.adapt(meta_params["net"], meta_params["lrs"],
                                 task, spec)
            with torch.no_grad():
                out = functional_call(self.model, adapted,
                                      (task[1][None], task[2][None]),
                                      self.apply_kwargs)
            preds.append((out[0] if self.returns_aux else out)[0])
        return torch.stack(preds)

    def batched_episode(self, meta_params: Dict[str, Params],
                        frames: torch.Tensor, msl_weights, spec: EpisodeSpec,
                        training: bool = False, with_metrics: bool = False):
        """Loop over tasks; frames (B, T, C, H, W). Returns (mean outer
        loss, aux) with aux['preds'] (B, C, H, W), aux['query_loss'] and,
        ``with_metrics``, the task-mean aux['psnr'] / aux['ssim'].

        Training backpropagates each task's outer loss over B as soon as
        it is taken, so the leaves of ``meta_params`` accumulate the
        gradient of the mean with only one task's graph alive (JAX's vmap
        and mean compute the same); the loss returned is detached."""
        outer, preds, q_losses = [], [], []
        for task in frames:
            o, pred, q = self.task_episode(meta_params, task, msl_weights,
                                           spec, training=training)
            if training:
                (o / len(frames)).backward()
                o = o.detach()
            outer.append(o)
            preds.append(pred)
            q_losses.append(q)
        preds = torch.stack(preds)
        aux = {"preds": preds, "query_loss": torch.stack(q_losses).mean()}
        if with_metrics:
            aux.update(self.metrics(preds, frames, spec))
        return torch.stack(outer).mean(), aux

    def metrics(self, preds: torch.Tensor, frames: torch.Tensor,
                spec: EpisodeSpec) -> Dict[str, torch.Tensor]:
        """Task-mean PSNR and SSIM of ``preds`` (B, C, H, W) against the
        query targets of ``frames`` (B, T, C, H, W)."""
        dn_tgt = self.denormalize(frames[:, spec.target_idxs[1]])
        psnr, ssim = zip(*(metrics_lib.calc_metrics(p, t) for p, t in
                           zip(self.denormalize(preds), dn_tgt)))
        return {"psnr": torch.stack(psnr).mean(),
                "ssim": torch.stack(ssim).mean()}
