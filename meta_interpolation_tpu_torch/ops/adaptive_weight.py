"""Adaptive weighted forward splatting — DAIN's AdaptiveWeightInterpolation
layers, which its active path does not run.

Counterpart of ``meta_interpolation_tpu/ops/adaptive_weight.py:41-183``
(reference ``FilterInterpolationLayer.py:82-533`` and
``FilterInterpolationModule.py:25-150``, whose CUDA side ships no kernels
for these layers; the semantics are the JAX package's reconstruction from
the module's dataflow):

  * :func:`weight_layer` — per-source flow confidence in (0, 1]:
    exp(−(e/λ_e)² − λ_v·var_Nw(f)), e the mean |I1(x) − I2(x + f(x))| of a
    bilinear sample, var_Nw the flow's variance over an Nw×Nw window;
  * :func:`pixel_value_layer` — each source pixel lands at x + f(x) and
    adds flow_weight·I1 to the (2·prowindow)² integer cells around it,
    with gaussian taps exp(−d²/(2σ_d²));
  * :func:`pixel_weight_layer` — the same splat of the weights alone;
  * :func:`reliable_weight_layer` — the same splat of ones;
  * :func:`adaptive_weight_interpolation` — both frames splatted along
    their flows, each normalised by its splatted weight and blended by
    its reliability.

The JAX package computes these with ``.at[].add`` scatters, outside any
TPU kernel; here they are ``index_add`` scatters, plain PyTorch on either
device, and their gradients come from autograd. Layouts: images (N, C, H,
W); flows (N, H, W, 2) in (fx, fy) order, as the port's warp ops take
them; weights (N, 1, H, W).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _grid(flow: torch.Tensor):
    n, h, w, _ = flow.shape
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    return xs + flow[..., 0], ys + flow[..., 1]


def _bilinear_sample(img: torch.Tensor, x2: torch.Tensor, y2: torch.Tensor
                     ) -> torch.Tensor:
    """img (N, C, H, W) at float coordinates (x2, y2) (N, H', W'), zero
    outside the image."""
    n, c, h, w = img.shape
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    x0 = torch.floor(x2).long().clamp(0, w - 1)
    y0 = torch.floor(y2).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    ax = (x2 - x0.to(x2.dtype))[:, None]
    ay = (y2 - y0.to(y2.dtype))[:, None]
    flat = img.reshape(n, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, -1).expand(n, c, -1)
        return flat.gather(2, idx).reshape(n, c, *x2.shape[1:])

    v = (at(y0, x0) * (1 - ax) * (1 - ay) + at(y0, x1) * ax * (1 - ay)
         + at(y1, x0) * (1 - ax) * ay + at(y1, x1) * ax * ay)
    return torch.where(valid[:, None], v, v.new_zeros(()))


def weight_layer(img1: torch.Tensor, img2: torch.Tensor, flow1: torch.Tensor,
                 lambda_e: float = 30.0 / 255.0, lambda_v: float = 1.0,
                 nw: int = 3) -> torch.Tensor:
    """Flow-confidence weights (N, 1, H, W) in (0, 1]."""
    h, w = img1.shape[2:]
    x2, y2 = _grid(flow1)
    warped = _bilinear_sample(img2, x2, y2)
    err = torch.mean(torch.abs(img1 - warped), dim=1, keepdim=True)
    val = (err / lambda_e) ** 2
    if lambda_v > 0 and nw > 1:
        pad = nw // 2
        fpad = F.pad(flow1.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                     mode="replicate")
        win = torch.stack([fpad[:, :, dy:dy + h, dx:dx + w]
                           for dy in range(nw) for dx in range(nw)])
        var = torch.var(win, dim=0, unbiased=False).mean(1, keepdim=True)
        val = val + lambda_v * var
    return torch.exp(-val)


def _splat(values: Optional[torch.Tensor], flow: torch.Tensor,
           flow_weights: Optional[torch.Tensor], sigma_d: float,
           prowindow: int) -> torch.Tensor:
    """Σ_x g(z − x − f(x))·fw(x)·v(x) onto each cell z, over the integer
    offsets within ±prowindow of the landing point; ``values`` None
    splats the weights alone. → (N, C or 1, H, W)."""
    n, h, w, _ = flow.shape
    x2, y2 = _grid(flow)
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    fw = (flow_weights[:, 0] if flow_weights is not None
          else torch.ones_like(x2))
    fw = torch.where(valid, fw, fw.new_zeros(()))
    ix0 = torch.floor(x2).long().clamp(0, w - 1)
    iy0 = torch.floor(y2).long().clamp(0, h - 1)
    c = values.shape[1] if values is not None else 1
    src = (values.permute(0, 2, 3, 1) if values is not None
           else None)                                   # (N, H, W, C)
    base = (torch.arange(n, device=flow.device) * (h * w))[:, None, None]
    acc = flow.new_zeros((n * h * w, c))
    inv2s2 = 1.0 / (2.0 * sigma_d * sigma_d)
    for dy in range(-prowindow + 1, prowindow + 1):
        for dx in range(-prowindow + 1, prowindow + 1):
            iz_x, iz_y = ix0 + dx, iy0 + dy
            inb = (iz_x >= 0) & (iz_x < w) & (iz_y >= 0) & (iz_y < h)
            d2 = (iz_x.to(x2.dtype) - x2) ** 2 + (iz_y.to(y2.dtype) - y2) ** 2
            g = torch.exp(-d2 * inv2s2) * fw * inb.to(x2.dtype)
            contrib = src * g[..., None] if src is not None else g[..., None]
            idx = base + iz_y.clamp(0, h - 1) * w + iz_x.clamp(0, w - 1)
            acc = acc.index_add(0, idx.reshape(-1), contrib.reshape(-1, c))
    return acc.reshape(n, h, w, c).permute(0, 3, 1, 2)


def pixel_value_layer(img1: torch.Tensor, flow1: torch.Tensor,
                      flow_weights: torch.Tensor, sigma_d: float = 1.5,
                      tao_r: float = 0.05, prowindow: int = 2
                      ) -> torch.Tensor:
    """Weighted forward splat of the image → (N, C, H, W). ``tao_r`` is
    taken for the reference's signature and unused, as there."""
    del tao_r
    return _splat(img1, flow1, flow_weights, sigma_d, prowindow)


def pixel_weight_layer(flow1: torch.Tensor, flow_weights: torch.Tensor,
                       sigma_d: float = 1.5, tao_r: float = 0.05,
                       prowindow: int = 2) -> torch.Tensor:
    """Splat of the flow weights alone → (N, 1, H, W)."""
    del tao_r
    return _splat(None, flow1, flow_weights, sigma_d, prowindow)


def reliable_weight_layer(flow1: torch.Tensor, sigma_d: float = 1.5,
                          tao_r: float = 0.05, prowindow: int = 2
                          ) -> torch.Tensor:
    """Splat of ones → (N, 1, H, W), the coverage."""
    del tao_r
    return _splat(None, flow1, None, sigma_d, prowindow)


def adaptive_weight_interpolation(img1: torch.Tensor, img2: torch.Tensor,
                                  flow1: torch.Tensor, flow2: torch.Tensor,
                                  training: bool = False,
                                  threshold: float = 1e-6,
                                  lambda_e: float = 30.0 / 255.0,
                                  lambda_v: float = 1.0, nw: int = 3,
                                  sigma_d: float = 1.5, tao_r: float = 0.05,
                                  prowindow: int = 2) -> torch.Tensor:
    """AdaptiveWeightInterpolationModule.forward: each frame splatted along
    its flow and normalised by its splatted weight, blended by w_i = pw_i
    / (rw_i + ε); outside training a pixel whose w₁ + w₂ ≤ 10ε is 0."""
    def one(a, b, flow):
        fw = weight_layer(a, b, flow, lambda_e, lambda_v, nw)
        p = pixel_value_layer(a, flow, fw, sigma_d, tao_r, prowindow)
        pw = pixel_weight_layer(flow, fw, sigma_d, tao_r, prowindow)
        rw = reliable_weight_layer(flow, sigma_d, tao_r, prowindow)
        return p / (pw + threshold), pw / (rw + threshold)

    i1, w1 = one(img1, img2, flow1)
    i2, w2 = one(img2, img1, flow2)
    wsum = w1 + w2
    out = (i1 * w1 + i2 * w2) / (wsum + threshold)
    if not training:
        out = torch.where(wsum <= 10 * threshold, out.new_zeros(()), out)
    return out
