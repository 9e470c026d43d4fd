"""Image quality metrics — PSNR / SSIM with the reference's semantics.

Counterpart of ``meta_interpolation_tpu/core/metrics.py:22-144``, in NCHW:
  * quantize both images to 0..255 with round (half to even) and clamp;
  * PSNR = −10·log10(mean(((p−g)/255)²) + 1e-8);
  * SSIM with an 11×11 gaussian window (σ = 1.5), no padding, C1/C2 from
    the value range, mean over the whole valid map.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def quantize(img: torch.Tensor, rgb_range: float = 1.0) -> torch.Tensor:
    """[0, rgb_range] image → quantized 0..255 (reference utils.py:171-172)."""
    return torch.round(torch.clamp(img * (255.0 / rgb_range), 0.0, 255.0))


def psnr_from_quantized(pred255: torch.Tensor, gt255: torch.Tensor
                        ) -> torch.Tensor:
    diff = (pred255 - gt255) / 255.0
    mse = torch.mean(diff * diff) + 1e-8
    return -10.0 * torch.log10(mse)


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _window_filter(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise separable valid conv with the 1-D window: H pass, W pass."""
    c, k = img.shape[1], win.shape[0]
    out = F.conv2d(img, win.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(out, win.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         val_range: Optional[float] = 255.0,
         window_size: int = 11) -> torch.Tensor:
    """SSIM of NCHW batches, a scalar mean. ``val_range=None`` detects the
    range from ``img1`` (reference pytorch_msssim/__init__.py:21-31); the
    window shrinks to min(window_size, H, W)."""
    img1 = img1.float()
    img2 = img2.float()
    if val_range is None:
        max_val = torch.where(img1.max() > 128, 255.0, 1.0)
        min_val = torch.where(img1.min() < -0.5, -1.0, 0.0)
        val_range = max_val - min_val
    h, w = img1.shape[2], img1.shape[3]
    win = torch.as_tensor(_gaussian_window(min(window_size, h, w)),
                          device=img1.device)
    mu1 = _window_filter(img1, win)
    mu2 = _window_filter(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _window_filter(img1 * img1, win) - mu1_sq
    sigma2_sq = _window_filter(img2 * img2, win) - mu2_sq
    sigma12 = _window_filter(img1 * img2, win) - mu1_mu2
    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma1_sq + sigma2_sq + c2
    ssim_map = ((2.0 * mu1_mu2 + c1) * v1) / ((mu1_sq + mu2_sq + c1) * v2)
    return ssim_map.mean()


def calc_metrics(pred: torch.Tensor, gt: torch.Tensor):
    """Quantize, then (PSNR, SSIM) as 0-d tensors (reference
    utils.py:195-204). ``pred``/``gt``: NCHW or CHW in [0, 1]."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    q_pred = quantize(pred)
    q_gt = quantize(gt)
    return psnr_from_quantized(q_pred, q_gt), ssim(q_pred, q_gt, 255.0)
