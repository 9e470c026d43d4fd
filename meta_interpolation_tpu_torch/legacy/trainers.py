"""Reptile and first-order-MAML steps over ``{name: tensor}`` weights.

Counterpart of ``meta_interpolation_tpu/legacy/trainers.py:24-132``
(reference ``legacy/train_sepconv.py:104-180``; the same loop in
train_voxelflow.py:160-206, train_superslomo.py:280-340 and
train_dain.py:200-280). The model runs through
``torch.func.functional_call``, once a support pair over the whole batch.
The inner rule is a fresh fixed-rate ``InnerOptimizer`` every batch, as
the scripts build a fresh ``torch.optim.Adamax``/``Adam`` each iteration.

``mask``: {name: trained?}; a name it leaves off is frozen in both loops
(DAIN adapts and trains its rectify net only, train_dain.py:210). Its
inner gradient is zero, where Adam's and Adamax's step is exactly zero,
so it is neither computed nor stepped here; the outer optimizer never
sees it. frames: (B, 7, C, H, W) in model input space.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..meta.inner_optimizers import InnerOptimizer

Params = Dict[str, torch.Tensor]
SUPPORT = ((0, 2, 4), (2, 4, 6))
QUERY = (2, 3, 4)


def _apply_pair(model: nn.Module, params: Params, f0, f1):
    """The model on (f0, f1) → (pred, aux); a model that returns (pred,
    aux) (SuperSloMo) gets ``I0``/``I1`` added to its aux, else aux is
    None."""
    out = functional_call(model, params, (f0, f1))
    if isinstance(out, tuple):
        pred, aux = out
        return pred, {**aux, "I0": f0, "I1": f1}
    return out, None


def _call_loss(loss_fn: Callable, pred, target, aux):
    """``loss_fn(pred, target)``, or with ``aux`` when the model gave one."""
    if aux is None:
        return loss_fn(pred, target)
    return loss_fn(pred, target, aux)


def _query(model, loss_fn, params, frames):
    i0, it, i1 = QUERY
    pred, aux = _apply_pair(model, params, frames[:, i0], frames[:, i1])
    return _call_loss(loss_fn, pred, frames[:, it], aux), pred


def _adapt(model: nn.Module, loss_fn: Callable, params: Params,
           frames: torch.Tensor, inner_lr: float, num_steps: int,
           support_idxs=SUPPORT, inner_rule: str = "Adamax",
           mask: Optional[Dict[str, bool]] = None) -> Params:
    """k inner steps on the support pairs (reference :117-128): each the
    first-order gradient of the summed support losses, stepped by a fresh
    fixed-rate inner rule. Returns new tensors, off the tape."""
    opt = InnerOptimizer(rule=inner_rule, lr_mode="fixed",
                         num_steps=num_steps)
    live = [k for k in params if mask is None or mask[k]]
    params = {k: v.detach() for k, v in params.items()}
    lrs = opt.init_lrs({k: params[k] for k in live}, inner_lr)
    state = opt.init_state({k: params[k] for k in live})
    for step in range(num_steps):
        src = dict(params)
        for k in live:
            src[k] = params[k].detach().requires_grad_(True)
        total = 0.0
        for i0, it, i1 in support_idxs:
            pred, aux = _apply_pair(model, src, frames[:, i0], frames[:, i1])
            total = total + _call_loss(loss_fn, pred, frames[:, it], aux)
        grads = torch.autograd.grad(total, [src[k] for k in live])
        new, state = opt.update({k: params[k] for k in live},
                                dict(zip(live, grads)), lrs, state, step)
        params.update(new)
    return params


def reptile_step(model: nn.Module, loss_fn: Callable, params: Params,
                 frames: torch.Tensor, inner_lr: float, outer_lr: float,
                 num_steps: int = 1, inner_rule: str = "Adamax",
                 mask: Optional[Dict[str, bool]] = None
                 ) -> Tuple[Params, torch.Tensor]:
    """θ ← θ + ε(θ′ − θ) (reference :130-136), then the query loss at the
    new weights under no-grad (:138-143). Returns (new params, query
    loss)."""
    adapted = _adapt(model, loss_fn, params, frames, inner_lr, num_steps,
                     inner_rule=inner_rule, mask=mask)
    new = {k: w + (adapted[k] - w) * outer_lr for k, w in params.items()}
    with torch.no_grad():
        q_loss, _ = _query(model, loss_fn, new, frames)
    return new, q_loss


def fomaml_step(model: nn.Module, loss_fn: Callable, params: Params,
                outer_opt: torch.optim.Optimizer, frames: torch.Tensor,
                inner_lr: float, num_steps: int = 1,
                inner_rule: str = "Adamax",
                mask: Optional[Dict[str, bool]] = None
                ) -> Tuple[Params, torch.Tensor]:
    """First-order MAML (reference :145-180): the query gradient at the
    adapted weights, given to ``outer_opt``, which holds the tensors of
    ``params`` and steps them in place. A tensor ``mask`` leaves off gets
    no gradient, so the optimizer neither updates it nor keeps moments for
    it (JAX masks both the gradient and the update). Returns (params,
    query loss)."""
    adapted = _adapt(model, loss_fn, params, frames, inner_lr, num_steps,
                     inner_rule=inner_rule, mask=mask)
    live = [k for k in params if mask is None or mask[k]]
    for k in live:
        adapted[k].requires_grad_(True)
    loss, _ = _query(model, loss_fn, adapted, frames)
    grads = dict(zip(live, torch.autograd.grad(
        loss, [adapted[k] for k in live])))
    for k, p in params.items():
        p.grad = grads.get(k)
    outer_opt.step()
    outer_opt.zero_grad(set_to_none=True)
    return params, loss.detach()


def eval_episode(model: nn.Module, loss_fn: Callable, params: Params,
                 frames: torch.Tensor, inner_lr: float, num_steps: int,
                 inner_rule: str = "Adamax",
                 mask: Optional[Dict[str, bool]] = None):
    """The legacy validate() body (reference :218-263): adapt a throwaway
    copy on the support pairs, then the query under no-grad. Returns
    (query loss, pred)."""
    adapted = _adapt(model, loss_fn, params, frames, inner_lr, num_steps,
                     inner_rule=inner_rule, mask=mask)
    with torch.no_grad():
        loss, pred = _query(model, loss_fn, adapted, frames)
    return loss, pred
