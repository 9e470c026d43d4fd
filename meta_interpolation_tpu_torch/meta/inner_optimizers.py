"""Functional inner-loop optimizers over ``{name: tensor}`` dicts.

Counterpart of ``meta_interpolation_tpu/meta/inner_optimizers.py:37-143``
(reference ``inner_loop_optimizers.py``): SGD, Adam and Adamax update
rules, each with a fixed LR, LSLR (per-layer, per-step LR vectors of
length ``num_steps + 1``) or Meta-SGD (per-parameter LR tensors). β1=0.9,
β2=0.99, eps=1e-8, no weight decay; Adamax adds eps to |g| before the max.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

BETA1 = 0.9
BETA2 = 0.99
EPS = 1e-8

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class InnerOptimizer:
    rule: str = "Adam"          # 'SGD' | 'Adam' | 'Adamax'
    lr_mode: str = "lslr"       # 'lslr' | 'metasgd' | 'fixed'
    num_steps: int = 1
    learnable: bool = True

    def init_lrs(self, params: Params, init_lr: float) -> Params:
        def one(p):
            if self.lr_mode == "metasgd":
                shape = p.shape
            elif self.lr_mode == "lslr":
                shape = (self.num_steps + 1,)
            else:
                shape = ()
            return torch.full(shape, init_lr, dtype=torch.float32,
                              device=p.device)
        return {k: one(p) for k, p in params.items()}

    def _step_lr(self, lr: torch.Tensor, step_idx: int) -> torch.Tensor:
        return lr[step_idx] if self.lr_mode == "lslr" else lr

    def init_state(self, params: Params) -> dict:
        """Fresh per-task state (reference initialize_state(), :104-107)."""
        if self.rule == "SGD":
            return {"step": 0}
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        if self.rule == "Adam":
            return {"step": 0, "exp_avg": zeros(), "exp_avg_sq": zeros()}
        if self.rule == "Adamax":
            return {"step": 0, "exp_avg": zeros(), "exp_inf": zeros()}
        raise NotImplementedError(f"inner rule {self.rule!r}")

    def update(self, params: Params, grads: Params, lrs: Params, state: dict,
               step_idx: int) -> Tuple[Params, dict]:
        """One inner step over the names in ``grads`` → (new params, new
        state). Pure: the inputs are not modified."""
        lr = {k: self._step_lr(lrs[k], step_idx) for k in grads}
        if self.rule == "SGD":
            return {k: params[k] - lr[k] * g for k, g in grads.items()}, state

        step = state["step"] + 1
        bias_c1 = 1.0 - BETA1 ** step
        new_m = {k: BETA1 * state["exp_avg"][k] + (1 - BETA1) * g
                 for k, g in grads.items()}
        if self.rule == "Adam":
            bias_c2 = 1.0 - BETA2 ** step
            new_v = {k: BETA2 * state["exp_avg_sq"][k] + (1 - BETA2) * g * g
                     for k, g in grads.items()}
            # the 1e-24 shift keeps grad-of-sqrt finite at v = 0
            new_params = {
                k: params[k] - (lr[k] / bias_c1) * new_m[k]
                / (torch.sqrt(new_v[k] + 1e-24) / bias_c2 ** 0.5 + EPS)
                for k in grads}
            return new_params, {"step": step, "exp_avg": new_m,
                                "exp_avg_sq": new_v}
        if self.rule == "Adamax":
            new_u = {k: torch.maximum(BETA2 * state["exp_inf"][k],
                                      torch.abs(g) + EPS)
                     for k, g in grads.items()}
            new_params = {k: params[k] - (lr[k] / bias_c1) * new_m[k]
                          / new_u[k] for k in grads}
            return new_params, {"step": step, "exp_avg": new_m,
                                "exp_inf": new_u}
        raise NotImplementedError(f"inner rule {self.rule!r}")


def make_inner_optimizer(cfg) -> InnerOptimizer:
    """Build from a Config (reference meta_learning_system.py:83-94)."""
    if cfg.metasgd:
        lr_mode, learnable = "metasgd", True
    elif cfg.learnable_per_layer_per_step_inner_loop_learning_rate:
        lr_mode, learnable = "lslr", True
    else:
        lr_mode, learnable = "lslr", False  # LSLR container, frozen LRs
    return InnerOptimizer(rule=cfg.optimizer, lr_mode=lr_mode,
                          num_steps=cfg.number_of_training_steps_per_iter,
                          learnable=learnable)
