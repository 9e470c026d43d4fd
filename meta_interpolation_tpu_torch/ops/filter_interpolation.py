"""Filter interpolation — warp by a flow through a per-pixel 4×4 adaptive
filter with bilinear quadrant weights (DAIN).

Counterpart of ``meta_interpolation_tpu/ops/filter_interpolation.py``
(reference ``filterinterpolation_cuda_kernel.cu``). For each output pixel
(y, x) with flow (fx, fy) the sample point is (x2, y2) = (x+fx, y+fy).
Where it is valid (inside the image, |fx| < W/2 and |fy| < H/2) the 4×4
window anchored at (⌊y2⌋−1, ⌊x2⌋−1) of the edge-clamped source is weighted
by the 16-channel filter and the bilinear quadrant factors ((1−α)(1−β),
α(1−β), (1−α)β, αβ) of its T/B rows and L/R columns; elsewhere the source
passes through unchanged.

The JAX op is an XLA gather, not a TPU kernel, so this is plain PyTorch:
one gather of all 16 taps from an edge-padded copy (1 top/left, 2
bottom/right, which makes the window's border clamping the reference's),
slabbed over channels so that the (N, C, 16, H, W) window temporary stays
under ``WINDOW_SLAB_BYTES``. Gradients come from autograd.

Layouts: img (N, C, H, W); flow (N, H, W, 2) in (fx, fy) order, as the
port's warp ops take it; filters (N, 16, H, W).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

FILTER_SIZE = 4
# cap on one slab's (N, C, 16, H, W) window temporary, as the JAX package's
# _WINDOW_SLAB_BYTES
WINDOW_SLAB_BYTES = 768 * 2**20


def filter_interpolation(img: torch.Tensor, flow: torch.Tensor,
                         filters: torch.Tensor) -> torch.Tensor:
    n, c, h, w = img.shape
    fs = FILTER_SIZE
    # coordinate math at float32 or wider
    ct = torch.promote_types(flow.dtype, torch.float32)
    fx, fy = flow[..., 0].to(ct), flow[..., 1].to(ct)
    xs = torch.arange(w, dtype=ct, device=img.device)[None, None, :]
    ys = torch.arange(h, dtype=ct, device=img.device)[None, :, None]
    x2, y2 = xs + fx, ys + fy
    valid = ((x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
             & (fx.abs() < w / 2.0) & (fy.abs() < h / 2.0))
    x2f, y2f = torch.floor(x2), torch.floor(y2)
    alpha = (x2 - x2f).to(img.dtype)[:, None]        # (N, 1, H, W)
    beta = (y2 - y2f).to(img.dtype)[:, None]
    wrow = [1.0 - beta] * (fs // 2) + [beta] * (fs // 2)
    wcol = [1.0 - alpha] * (fs // 2) + [alpha] * (fs // 2)
    wgts = torch.cat([filters[:, j * fs + i:j * fs + i + 1] * wrow[j] * wcol[i]
                      for j in range(fs) for i in range(fs)], 1)

    # window origin in the padded copy: row ⌊y2⌋ − 1 + 1, clamped so the
    # four rows stay inside it (invalid pixels pass through below anyway)
    row = y2f.long().clamp(0, h - 1)
    col = x2f.long().clamp(0, w - 1)
    wp = w + 3
    taps = torch.arange(fs, device=img.device)
    offs = (taps[:, None] * wp + taps[None, :]).reshape(fs * fs)
    index = ((row * wp + col)[:, None] + offs[None, :, None, None]).reshape(
        n, 1, fs * fs * h * w)
    pad = F.pad(img, (1, 2, 1, 2), mode="replicate").reshape(n, c, -1)

    per_ch = n * fs * fs * h * w * img.element_size()
    cs = max(1, min(c, WINDOW_SLAB_BYTES // per_ch))
    outs = []
    for c0 in range(0, c, cs):
        sl = pad[:, c0:c0 + cs]
        vals = sl.gather(2, index.expand(n, sl.shape[1], -1)).view(
            n, sl.shape[1], fs * fs, h, w)
        outs.append((vals * wgts[:, None]).sum(2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    return torch.where(valid[:, None], out, img)
