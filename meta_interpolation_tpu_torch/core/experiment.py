"""Experiment runner — evaluation.

Counterpart of ``meta_interpolation_tpu/core/experiment.py:76-97,124-170,
217-234`` (reference ``experiment_builder.py``): the validation loop with
recursive spatial tiling of oversized frames and PSNR/SSIM on the
stitched full-frame prediction. Training and the ×2 slow-motion test mode
are later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..utils.meters import AverageMeter
from . import metrics as metrics_lib


class ExperimentBuilder:
    def __init__(self, cfg: Config, data, system):
        unported = [flag for flag, on in [
            ("--resume", cfg.resume), ("--viz", cfg.viz),
            ("--lpips", cfg.lpips), ("--use_tensorboard", cfg.use_tensorboard),
            ("--profile_dir", cfg.profile_dir)] if on]
        if unported:
            raise NotImplementedError(
                f"not ported to PyTorch yet: {', '.join(unported)}")
        self.cfg = cfg
        self.data = data
        self.system = system

    def _tiled_val_iter(self, frames: np.ndarray, limit: float):
        """Recursively split H or W in half while H·W exceeds the limit;
        average losses, concatenate predictions (no halo — seams accepted,
        as in the reference). frames: (B, T, H, W, C)."""
        h, w = frames.shape[2], frames.shape[3]
        if h * w <= limit:
            return self.system.run_validation_iter(frames)
        if h >= w:
            a, b, dim = frames[:, :, :h // 2], frames[:, :, h // 2:], 2
        else:
            a, b, dim = frames[:, :, :, :w // 2], frames[:, :, :, w // 2:], 3
        losses_a, preds_a = self._tiled_val_iter(a, limit)
        losses_b, preds_b = self._tiled_val_iter(b, limit)
        losses = {k: (losses_a[k] + losses_b[k]) / 2.0 for k in losses_a}
        # preds are (B, C, H, W): H is dim 2, W dim 3
        return losses, torch.cat([preds_a, preds_b], dim=dim)

    def validate(self, epoch: int = 0, total_batches: int = -1):
        loss_meter, psnr_meter, ssim_meter = (AverageMeter(), AverageMeter(),
                                              AverageMeter())
        limit = self.system.model_def.tile_pixel_limit
        dn = self.system.model_def.denormalize
        qt = self.cfg.target_idxs[1]
        for frames, _meta in self.data.get_val_batches(total_batches):
            frames_np = np.asarray(frames)
            losses, preds = self._tiled_val_iter(frames_np, limit)
            loss_meter.update(losses["loss"])
            # reference metric protocol (experiment_builder.py:115,131-141):
            # PSNR/SSIM once on the stitched full-frame prediction of batch
            # element 0, never a mean of per-tile PSNRs
            tgt0 = torch.as_tensor(np.ascontiguousarray(
                frames_np[0, qt].transpose(2, 0, 1)), device=preds.device)
            psnr_v, ssim_v = metrics_lib.calc_metrics(dn(preds[0]), dn(tgt0))
            psnr_meter.update(float(psnr_v))
            ssim_meter.update(float(ssim_v))
        print(f"[val epoch {epoch}] loss {loss_meter.avg:.4f} "
              f"PSNR {psnr_meter.avg:.3f} SSIM {ssim_meter.avg:.4f}")
        return {"loss": loss_meter.avg, "psnr": psnr_meter.avg,
                "ssim": ssim_meter.avg}

    def run_experiment(self):
        if self.cfg.mode == "val":
            return self.validate()
        raise NotImplementedError(
            f"--mode {self.cfg.mode} is not ported to PyTorch yet; the port "
            f"runs --mode val")
