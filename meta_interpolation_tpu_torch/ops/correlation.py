"""Cost-volume correlation (PWC-Net), NCHW.

Counterpart of ``meta_interpolation_tpu/ops/correlation.py`` (the
reference's ``Correlation(pad_size=4, kernel_size=1, max_displacement=4)``):

    out[(tj+d)·(2d+1) + (ti+d)](y, x) = mean_c f1(c, y, x) · f2(c, y+tj, x+ti)

for tj, ti ∈ [−d, d], zero padding outside. The JAX op is XLA, not a TPU
kernel, so this is plain PyTorch: one ``F.unfold`` of the zero-padded f2
gathers all (2d+1)² shifts at once, and one multiply and one mean over C
make the volume (rather than 81 shifted multiply-and-mean pairs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """(N, C, H, W) feature maps → (N, (2d+1)², H, W) cost volume."""
    n, c, h, w = f1.shape
    k = 2 * max_displacement + 1
    shifted = F.unfold(f2, k, padding=max_displacement).view(n, c, k * k, h,
                                                             w)
    return (f1[:, :, None] * shifted).mean(1)
