"""Image and video export (reference utils.py:276-387).

The port's own copy of ``meta_interpolation_tpu/utils/viz.py``; its
predictions are NCHW tensors, written as HWC 8-bit PNGs.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np
import torch


def save_image(img01: np.ndarray, path: str):
    """Save an HWC [0, 1] float image (reference utils.save_image): ×255,
    rounded half up, clipped to 8 bits; the format follows the file's
    extension."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(img01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def to_hwc(img: torch.Tensor) -> np.ndarray:
    """A CHW tensor → an HWC float32 numpy image."""
    return img.detach().cpu().float().numpy().transpose(1, 2, 0)


def save_batch_images(preds: torch.Tensor, paths_meta, out_root: str,
                      target_idx: int = 3) -> List[str]:
    """Save each prediction of ``preds`` (B, C, H, W) under ``out_root``,
    named after its clip's target path with '/' → '_' and ':' dropped
    (reference experiment_builder.py:227-234)."""
    saved = []
    for b in range(preds.shape[0]):
        imgpaths = paths_meta[b]["imgpaths"]
        name = str(imgpaths[target_idx]).replace("/", "_").replace(":", "")
        path = os.path.join(out_root, f"{name or f'pred_{b}'}.png")
        save_image(to_hwc(preds[b]), path)
        saved.append(path)
    return saved


def make_video(frame_dir: str, out_path: str, fps: int = 30,
               img_fmt: str = "png") -> Optional[str]:
    """Assemble the frames of ``frame_dir`` into a video with ffmpeg
    (utils.py:362-387); None, with a message, when there is no ffmpeg or no
    frame."""
    if shutil.which("ffmpeg") is None:
        print("[viz] ffmpeg not found — skipping video export")
        return None
    pattern = os.path.join(frame_dir, f"*.{img_fmt}")
    if not glob.glob(pattern):
        return None
    cmd = ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
           "-i", pattern, "-pix_fmt", "yuv420p", out_path]
    subprocess.run(cmd, check=False, capture_output=True)
    return out_path
