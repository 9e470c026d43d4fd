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
(SuperSloMo) hand it to the loss in every pass, training included.

Under ``--dtype bfloat16`` (``EpisodeBuilder.dtype``) every forward runs as
the JAX system's ``bf16_apply`` (``meta/system.py:311-323``): the frames
and the weights go in as bf16, the weights cast on the tape from their
float32 masters, and the prediction, its aux and the per-step BN state
come out as float32, so the loss, the inner rule and the outer update
stay float32.

The per-task state the JAX episode carries beside ``net`` and ``lrs``
rides in :class:`TaskState`: the L2F attenuator scales the initialisation
before the inner loop (``meta_params['attenuator']``), the per-step BN
statistics thread through every forward (``meta_params['bn_state']``), and
the adversarial loss reads the discriminator's parameters
(``meta_params['loss_ctx']``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..core import metrics as metrics_lib
from ..models.layers import torch_default_init_
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
    # L2F: scale the initialisation by the attenuator's gamma first
    attenuate: bool = False
    # keep the pre-update support predictions of every step and pair, and
    # the MSL query predictions of steps 0..n−2: the --disc_per_forward
    # replay's fakes (JAX EpisodeSpec, meta/episode.py:84-104)
    collect_support_preds: bool = False
    collect_query_preds: bool = False


def to_float32(tree):
    """Every floating tensor of a tensor, tuple, list or dict as float32
    (``bf16_apply``'s cast of the prediction and of every aux leaf)."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_float32(t) for t in tree)
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    return tree


def init_attenuator(num_layers: int,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> Params:
    """The L2F attenuator (JAX ``init_attenuator``, reference :106-117):
    Linear(L, L) → ReLU → Linear(L, L) → sigmoid over the per-tensor mean
    gradients, and ``gamma_mult`` at zero, so gamma starts at exactly 1.
    ``nn.Linear``'s init and layout, (out, in)."""
    out: Params = {}
    for name in ("fc1", "fc2"):
        fc = torch_default_init_(nn.Linear(num_layers, num_layers),
                                 generator)
        out[f"{name}.weight"] = fc.weight.detach()
        out[f"{name}.bias"] = fc.bias.detach()
    out["gamma_mult"] = torch.zeros(())
    return {k: v.to(device) for k, v in out.items()}


def apply_attenuator(att: Params, emb: torch.Tensor) -> torch.Tensor:
    """gamma = clip(1 − gamma_mult·σ(fc2(relu(fc1(emb)))), 0, 1). The clip
    is a maximum then a minimum, whose derivative splits at a tie as
    ``jnp.clip``'s does: at the init (gamma_mult 0, gamma exactly 1)
    gamma_mult takes half the gradient ``torch.clamp`` would give it."""
    h = torch.relu(F.linear(emb, att["fc1.weight"], att["fc1.bias"]))
    g = torch.sigmoid(F.linear(h, att["fc2.weight"], att["fc2.bias"]))
    gamma = 1.0 - att["gamma_mult"] * g
    return torch.minimum(torch.maximum(gamma, gamma.new_zeros(())),
                         gamma.new_ones(()))


class TaskState:
    """What one task's episode carries beside the weights: the loss's
    ``ctx`` (the discriminator's parameters, detached: they never train
    through the episode), the per-step BN statistics, which every forward
    reads and replaces in turn (support pair A → B → MSL query → next
    step → final query, as the reference mutates them), and the collected
    predictions of the --disc_per_forward replay."""

    def __init__(self, loss_ctx: Optional[Params] = None,
                 bn_state: Optional[Params] = None):
        self.ctx = (None if loss_ctx is None else
                    {"disc": {k: v.detach() for k, v in loss_ctx.items()}})
        self.bn_state = bn_state
        self.support_preds: List[torch.Tensor] = []
        self.query_preds: List[torch.Tensor] = []


class EpisodeBuilder:
    """Per-task and batched episodes for one model.

    ``model(f0, f1, **apply_kwargs) -> pred`` on NCHW frames, or ``(pred,
    aux)`` when ``returns_aux`` (SuperSloMo); ``loss_fn(pred, target, aux)
    -> {..., 'total'}``, aux None unless the model returns one;
    ``inner_keep``: optional {param name: adapted?}; ``apply_kwargs``:
    passed to every forward.

    Set by the system: ``uses_loss_ctx`` hands the loss ``ctx={'disc':
    meta_params['loss_ctx']}``; ``passes_bn_state`` calls the model with
    ``bn_state`` and ``num_step`` (the inner step; the final query the
    last) and takes ``(pred, new_bn_state)`` back; ``att_keep``, {param
    name: in the L2F embedding and scaled?}, None for every tensor;
    ``dtype``, the type the model computes in (float32, or bfloat16 for
    ``--dtype bfloat16``); ``remat`` (``--remat``), each forward under
    ``torch.utils.checkpoint``, so its activations are recomputed in its
    backward (JAX ``jax.checkpoint`` of the apply, ``meta/system.py
    :306-309``).
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
        self.uses_loss_ctx = False
        self.passes_bn_state = False
        self.att_keep: Optional[Dict[str, bool]] = None
        self.dtype = torch.float32
        self.remat = False

    def task_state(self, meta_params: Dict[str, Params]) -> TaskState:
        """A task's state at the start of its episode, from the
        meta-parameters."""
        return TaskState(
            meta_params.get("loss_ctx") if self.uses_loss_ctx else None,
            meta_params.get("bn_state") if self.passes_bn_state else None)

    def _forward(self, params: Params, f0, f1, num_step: int,
                 task: TaskState):
        """The model on one pair of CHW frames; with ``passes_bn_state``
        it reads and replaces ``task.bn_state``. In bf16 the frames and
        the floating weights are cast to bf16 (the weights differentiably,
        so gradients reach their float32 masters, as through JAX's
        ``astype``) and everything that comes out is cast to float32. Under
        ``remat`` the model runs inside a non-reentrant checkpoint: only
        its inputs are kept, and a backward through it runs the forward
        again first (each of its kernels launches once more)."""
        kwargs = self.apply_kwargs
        if self.passes_bn_state:
            kwargs = {**kwargs, "bn_state": task.bn_state,
                      "num_step": num_step}
        low = self.dtype != torch.float32
        if low:
            params = {k: v.to(self.dtype) if v.is_floating_point() else v
                      for k, v in params.items()}
            f0, f1 = f0.to(self.dtype), f1.to(self.dtype)
        if self.remat:
            out = checkpoint(
                lambda p, a, b: functional_call(self.model, p, (a, b),
                                                kwargs),
                params, f0[None], f1[None], use_reentrant=False)
        else:
            out = functional_call(self.model, params, (f0[None], f1[None]),
                                  kwargs)
        if low:
            out = to_float32(out)
        if self.passes_bn_state:
            out, task.bn_state = out
        return out

    def _pair_loss(self, params: Params, f0, f1, target, num_step: int = 0,
                   task: Optional[TaskState] = None):
        """One criterion call → (loss_total, pred); frames are CHW. A
        model's aux gains the unpadded inputs ``I0``, ``I1`` (batch 1), as
        JAX ``_pair_loss`` adds them (``meta/episode.py:239-261``)."""
        task = task if task is not None else TaskState()
        out = self._forward(params, f0, f1, num_step, task)
        aux = None
        if self.returns_aux:
            out, aux = out
            aux = {**aux, "I0": f0[None], "I1": f1[None]}
        ctx = {"ctx": task.ctx} if self.uses_loss_ctx else {}
        return self.loss_fn(out, target[None], aux, **ctx)["total"], out[0]

    def _support_loss(self, params: Params, frames, spec: EpisodeSpec,
                      num_step: int = 0, task: Optional[TaskState] = None,
                      collect: bool = False):
        task = task if task is not None else TaskState()
        total, preds = 0.0, []
        for i0, it, i1 in spec.support_idxs:
            loss, pred = self._pair_loss(params, frames[i0], frames[i1],
                                         frames[it], num_step, task)
            total = total + loss
            preds.append(pred.detach())
        if collect:
            task.support_preds.append(torch.stack(preds))
        return total

    def _live(self, params: Params):
        return [k for k in params
                if self.inner_keep is None or self.inner_keep[k]]

    def _attenuate(self, net_params: Params, attenuator: Params, frames,
                   spec: EpisodeSpec, task: TaskState) -> Params:
        """L2F (JAX ``_attenuate``, ``meta/episode.py:313-346``; reference
        :231-272): one first-order gradient of the support loss on
        detached parameters, inner-frozen tensors left out (their entry
        is zero); the embedding is each ``att_keep`` tensor's mean
        gradient; the initialisation of those tensors is scaled by their
        gamma, on the tape. The statistics these forwards write are
        dropped."""
        live = self._live(net_params)
        src = {k: v.detach() for k, v in net_params.items()}
        for k in live:
            src[k].requires_grad_(True)
        probe = TaskState()
        probe.ctx, probe.bn_state = task.ctx, task.bn_state
        loss = self._support_loss(src, frames, spec, 0, probe)
        grads = dict(zip(live, torch.autograd.grad(
            loss, [src[k] for k in live])))
        keep = [k for k in net_params
                if self.att_keep is None or self.att_keep[k]]
        emb = torch.stack([grads[k].mean() if k in grads
                           else net_params[k].new_zeros(()) for k in keep])
        gamma = apply_attenuator(attenuator, emb)
        scaled = dict(net_params)
        for i, k in enumerate(keep):
            scaled[k] = net_params[k] * gamma[i]
        return scaled

    def adapt(self, net_params: Params, lrs: Params, frames: torch.Tensor,
              spec: EpisodeSpec, msl_losses: Optional[list] = None,
              attenuator: Optional[Params] = None,
              task: Optional[TaskState] = None) -> Params:
        """Inner-loop adaptation on one task; frames (T, C, H, W).

        Returns the adapted parameters (inner-frozen ones unchanged); given
        ``msl_losses``, appends to it the query loss after each of steps
        0..n−2 (MSL). The update is recorded on the tape wherever
        ``net_params`` or ``lrs`` require grad; the support gradient is on
        detached copies unless ``spec.second_order``. With
        ``spec.attenuate`` the initialisation is first scaled by the
        ``attenuator``'s gamma. ``task`` carries the BN statistics and the
        loss's ctx through every forward, and collects the predictions the
        spec asks for."""
        task = task if task is not None else TaskState()
        if spec.attenuate and attenuator is not None:
            net_params = self._attenuate(net_params, attenuator, frames,
                                         spec, task)
        live = self._live(net_params)
        params = dict(net_params)
        state = self.inner_opt.init_state(
            {k: params[k].detach() for k in live})
        q0, qt, q1 = spec.target_idxs
        for step in range(spec.num_steps):
            if spec.second_order:
                loss = self._support_loss(params, frames, spec, step, task,
                                          spec.collect_support_preds)
                grads = torch.autograd.grad(
                    loss, [params[k] for k in live], create_graph=True)
            else:
                src = {k: v.detach() for k, v in params.items()}
                for k in live:
                    src[k].requires_grad_(True)
                loss = self._support_loss(src, frames, spec, step, task,
                                          spec.collect_support_preds)
                grads = torch.autograd.grad(loss, [src[k] for k in live])
            new, state = self.inner_opt.update(
                {k: params[k] for k in live}, dict(zip(live, grads)), lrs,
                state, step)
            params.update(new)
            if msl_losses is not None and step < spec.num_steps - 1:
                loss, pred = self._pair_loss(params, frames[q0], frames[q1],
                                             frames[qt], step, task)
                msl_losses.append(loss)
                if spec.collect_query_preds:
                    task.query_preds.append(pred.detach())
        return params

    def task_episode(self, meta_params: Dict[str, Params],
                     frames: torch.Tensor, msl_weights, spec: EpisodeSpec,
                     training: bool = False,
                     task: Optional[TaskState] = None):
        """Full episode on one task → (outer_loss, pred, query_loss), the
        prediction and query loss detached. Training keeps the outer loss
        on the tape: under MSL the weighted query losses of steps 0..n−2
        plus the last weight times the final query loss (JAX
        ``task_episode``, :524-581). In evaluation the query runs under
        no-grad and the outer loss is the query loss. ``task`` (default:
        :meth:`task_state`) ends with the task's BN statistics and
        collected predictions."""
        task = task if task is not None else self.task_state(meta_params)
        msl = training and spec.use_msl and spec.num_steps > 0
        step_losses = [] if msl else None
        adapted = self.adapt(meta_params["net"], meta_params["lrs"], frames,
                             spec, msl_losses=step_losses,
                             attenuator=meta_params.get("attenuator"),
                             task=task)
        q0, qt, q1 = spec.target_idxs
        # the reference's post-adaptation forward passes num_step =
        # num_steps, past its per-step rows; JAX clamps to the last row
        last = max(spec.num_steps - 1, 0)
        with torch.set_grad_enabled(training):
            q_loss, pred = self._pair_loss(adapted, frames[q0], frames[q1],
                                           frames[qt], last, task)
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
        midpoint of frames 1 and 2 under no-grad. Each task starts from the
        meta-parameters' BN statistics, and what it writes is dropped.
        frames (B, 4, C, H, W) → (B, C, H, W)."""
        preds = []
        for task_frames in frames:
            task = self.task_state(meta_params)
            adapted = self.adapt(meta_params["net"], meta_params["lrs"],
                                 task_frames, spec,
                                 attenuator=meta_params.get("attenuator"),
                                 task=task)
            with torch.no_grad():
                out = self._forward(adapted, task_frames[1], task_frames[2],
                                    max(spec.num_steps - 1, 0), task)
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
        and mean compute the same); the loss returned is detached.

        Per-step BN statistics: in training the tasks update the shared
        statistics one after another, the reference's order, and
        aux['bn_state'] is the last task's (the sequential composition JAX
        recovers in closed form, ``fold_bn_states_sequential``); in
        evaluation each task starts from the meta-parameters' statistics
        and its own are dropped. The collected predictions of the spec are
        aux['support_preds'] (B, S, P, C, H, W) and aux['query_preds'] (B,
        n − 1, C, H, W)."""
        outer, preds, q_losses = [], [], []
        sp, qp = [], []
        bn = meta_params.get("bn_state")
        for task_frames in frames:
            task = self.task_state(meta_params)
            if training and self.passes_bn_state:
                task.bn_state = bn
            o, pred, q = self.task_episode(meta_params, task_frames,
                                           msl_weights, spec,
                                           training=training, task=task)
            if training:
                (o / len(frames)).backward()
                o = o.detach()
                bn = task.bn_state
            outer.append(o)
            preds.append(pred)
            q_losses.append(q)
            if task.support_preds:
                sp.append(torch.stack(task.support_preds))
            if task.query_preds:
                qp.append(torch.stack(task.query_preds))
        preds = torch.stack(preds)
        aux = {"preds": preds, "query_loss": torch.stack(q_losses).mean()}
        if training and self.passes_bn_state:
            aux["bn_state"] = bn
        if sp:
            aux["support_preds"] = torch.stack(sp)
        if qp:
            aux["query_preds"] = torch.stack(qp)
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
