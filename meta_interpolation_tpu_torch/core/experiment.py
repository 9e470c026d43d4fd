"""Experiment runner — training and evaluation.

Counterpart of ``meta_interpolation_tpu/core/experiment.py`` (reference
``experiment_builder.py``): the epoch loop (train, validate, plateau
schedule, best-PSNR checkpoint; resume from the checkpoint), and the
validation loop with recursive spatial tiling of oversized frames and
PSNR/SSIM on the stitched full-frame prediction (and, with ``--viz``, its
images, and with ``--lpips`` LPIPS on the card), and the ×2 slow-motion
writer of ``--mode test``. ``--use_tensorboard`` logs the losses, PSNR and
SSIM to ``log_dir/exp_name`` (when the ``tensorboard`` package is there);
``--profile_dir`` traces the whole run (``utils/profiling.trace``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config
from ..utils.meters import AverageMeter
from . import checkpoint as ckpt_lib
from . import metrics as metrics_lib


class ExperimentBuilder:
    def __init__(self, cfg: Config, data, system):
        self.cfg = cfg
        self.data = data
        self.system = system
        self.best_psnr = 0.0
        self.start_epoch = cfg.start_epoch
        self.exp_dir = os.path.join(cfg.checkpoint_dir, cfg.exp_name)
        self.writer = None
        if cfg.use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(
                    os.path.join(cfg.log_dir, cfg.exp_name))
            except ImportError:
                print("[tb] tensorboard unavailable — logging disabled")
        if cfg.resume:
            self._resume()

    def _resume(self):
        exp = self.cfg.resume_exp or self.cfg.exp_name
        state = ckpt_lib.load_checkpoint(
            os.path.join(self.cfg.checkpoint_dir, exp))
        if state is None:
            print("[resume] no checkpoint found — training from scratch")
            return
        self.system.load_state_dict(state["system"])
        self.best_psnr = float(state.get("best_PSNR", 0.0))
        self.start_epoch = int(state.get("epoch", 0))
        print(f"[resume] epoch {self.start_epoch}, best PSNR "
              f"{self.best_psnr:.2f}")

    def _save(self, epoch: int, is_best: bool):
        ckpt_lib.save_checkpoint(
            {"epoch": epoch + 1, "arch": vars(self.cfg),
             "system": self.system.state_dict(),
             "best_PSNR": self.best_psnr},
            self.exp_dir, is_best=is_best)

    def _log_tb(self, tag_values: dict, step: int):
        if self.writer is None:
            return
        for tag, value in tag_values.items():
            self.writer.add_scalar(tag, value, step)
        self.writer.flush()

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

    def train_epoch(self, epoch: int):
        loss_meter, psnr_meter = AverageMeter(), AverageMeter()
        t0 = time.time()
        for it, (frames, _meta) in enumerate(self.data.get_train_batches(
                total_batches=self.cfg.total_iter_per_epoch, epoch=epoch)):
            losses, _ = self.system.run_train_iter(
                frames, epoch, do_evaluation=(it % self.cfg.eval_iter == 0))
            loss_meter.update(losses["loss"])
            if "psnr" in losses:
                psnr_meter.update(losses["psnr"])
            if it % self.cfg.log_iter == 0:
                msg = f"[epoch {epoch} it {it}] loss {loss_meter.avg:.4f}"
                if psnr_meter.count:
                    msg += f" psnr {psnr_meter.avg:.2f}"
                print(msg + f" ({time.time() - t0:.1f}s)")
                self._log_tb({"Loss/train": loss_meter.avg},
                             epoch * self.cfg.total_iter_per_epoch + it)
        return loss_meter.avg

    def validate(self, epoch: int = 0, total_batches: int = -1,
                 save_images: bool = False):
        loss_meter, psnr_meter, ssim_meter = (AverageMeter(), AverageMeter(),
                                              AverageMeter())
        lpips_meter = AverageMeter()
        limit = self.system.model_def.tile_pixel_limit
        dn = self.system.model_def.denormalize
        qt = self.cfg.target_idxs[1]
        for frames, meta in self.data.get_val_batches(total_batches):
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
            if self.cfg.lpips:
                # reference utils.py:195-211: LPIPS beside PSNR/SSIM, on
                # the whole clipped batch in [0, 1]
                from ..utils.profiling import eval_lpips
                tgt = torch.as_tensor(np.ascontiguousarray(
                    frames_np[:, qt].transpose(0, 3, 1, 2)),
                    device=preds.device)
                lpips_meter.update(eval_lpips(dn(preds).clamp(0, 1),
                                              dn(tgt).clamp(0, 1)))
            if save_images and self.cfg.viz:
                from ..utils.viz import save_batch_images
                save_batch_images(preds, meta, os.path.join(
                    self.exp_dir, self.cfg.dataset))
        msg = (f"[val epoch {epoch}] loss {loss_meter.avg:.4f} "
               f"PSNR {psnr_meter.avg:.3f} SSIM {ssim_meter.avg:.4f}")
        if self.cfg.lpips:
            msg += f" LPIPS {lpips_meter.avg:.4f}"
        print(msg)
        self._log_tb({"Loss/val": loss_meter.avg, "PSNR": psnr_meter.avg,
                      "SSIM": ssim_meter.avg}, epoch)
        out = {"loss": loss_meter.avg, "psnr": psnr_meter.avg,
               "ssim": ssim_meter.avg}
        if self.cfg.lpips:
            out["lpips"] = lpips_meter.avg
        return out

    def test(self) -> int:
        """×2 slow motion: write each clip's synthesized midpoint beside its
        inputs, named with the mean of the pair's float indices, so a run
        on the output directory doubles the frame rate again (reference
        :184-209). Returns the count of frames written."""
        from ..utils.viz import save_image, to_hwc
        count = 0
        for frames, meta in self.data.get_test_batches():
            preds = self.system.run_test_iter(np.asarray(frames))
            for b in range(preds.shape[0]):
                paths = meta[b]["imgpaths"]
                p1, p2 = str(paths[1]), str(paths[2])
                idx1, idx2 = _float_index(p1), _float_index(p2)
                # a zero second index counts as 1.0 (reference :201-202): in
                # a freshly renamed directory every index is 0.000000, and
                # the frame goes at 0.5 between the pair instead of over the
                # first input
                if idx2 == 0:
                    idx2 = 1.0
                mid = (idx1 + idx2) / 2.0
                stem = (p1.rsplit("_", 1)[0] if "_" in os.path.basename(p1)
                        else p1.rsplit(".", 1)[0])
                if "://" in stem:
                    # a pseudo-path (synthetic://0/1) has no directory:
                    # write under the experiment's
                    rel = stem.split("://", 1)[1].replace("/", "_")
                    stem = os.path.join(self.exp_dir, "test_output", rel)
                    os.makedirs(os.path.dirname(stem), exist_ok=True)
                out_path = f"{stem}_{mid:.06f}.{self.cfg.img_fmt}"
                pred01 = to_hwc(self.system.model_def.denormalize(preds[b]))
                save_image(np.clip(pred01, 0, 1), out_path)
                count += 1
        print(f"[test] wrote {count} interpolated frames")
        return count

    def run_experiment(self):
        from ..utils.profiling import trace
        with trace(self.cfg.profile_dir,
                   cuda=self.system.device.type == "cuda"):
            if self.cfg.mode == "val":
                return self.validate(save_images=True)
            if self.cfg.mode == "test":
                return self.test()
            for epoch in range(self.start_epoch, self.cfg.max_epoch):
                self.train_epoch(epoch)
                val_stats = self.validate(
                    epoch, total_batches=self.cfg.total_iter_per_epoch)
                self.system.epoch_end(val_stats["loss"])
                is_best = val_stats["psnr"] > self.best_psnr
                self.best_psnr = max(self.best_psnr, val_stats["psnr"])
                self._save(epoch, is_best)
            return {"best_psnr": self.best_psnr}


def _float_index(path: str) -> float:
    """The float index of a ``name_%.06f.ext`` frame; 0.0 for any other
    name."""
    try:
        return float(path.split("_")[-1].rsplit(".", 1)[0])
    except ValueError:
        return 0.0
