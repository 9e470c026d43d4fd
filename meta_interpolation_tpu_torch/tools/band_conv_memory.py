"""Peak memory of a SuperSloMo validation clip on one of 2 row-band ranks
of one CUDA card, with the banded zero-padded conv in each of three
forms, against one process.

    PYTHONPATH=. python3 -m meta_interpolation_tpu_torch.tools.band_conv_memory

Run it from the root of a checkout: chip_smoke.py is imported from there
(the preset, ``SSM_FLAGS``, and ``peak_memory_by_block``). One process
runs the clip at 256x448 first, then 2 gloo ranks
(``parallel/launch.spawn``) run it with ``--spatial_shards 2``, once for
each form of ``models/layers.band_conv``'s zero-padded conv: "padded"
(the checkout's: the halo band padded on all sides, the rows past the
halo cropped), "columns" (padded in its columns only) and "pad_columns"
(the columns padded by ``F.pad``, no padding in the conv). Rank 0 prints,
per form, its peak above what it held before, the seconds of 3 clips and
its prediction's largest difference from the checkout's form; the one
process and the columns-only form also the largest blocks live at the
allocator's peak. cuDNN runs deterministic, as in chip_smoke.py's ranks.
"""
from __future__ import annotations

import time

import torch
import torch.nn.functional as F

import chip_smoke as cs
from meta_interpolation_tpu_torch.models import layers
from meta_interpolation_tpu_torch.parallel import spatial

HW = (256, 448)
CLIPS = 3


def _columns(x, weight, bias, pad, reflect=False):
    xh = spatial.halo_rows(x, pad)
    return F.conv2d(xh, weight, bias, padding=(0, pad))


def _pad_columns(x, weight, bias, pad, reflect=False):
    xh = spatial.halo_rows(x, pad)
    return F.conv2d(F.pad(xh, (pad, pad, 0, 0)), weight, bias)


FORMS = {"padded": layers.band_conv, "columns": _columns,
         "pad_columns": _pad_columns}


def _episode(mesh):
    """The clip's validation on ``mesh`` (None: one process), as a
    function of no arguments, after one warm-up run."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    flags = cs.SSM_FLAGS + (["--spatial_shards", "2"] if mesh else [])
    system = SceneAdaptiveInterpolation(get_args(flags), mesh=mesh)
    clip = SyntheticSeptuplet(model="superslomo", mode="val",
                              size=HW)[0][0][None]
    system.run_validation_iter(clip)
    return lambda: system.run_validation_iter(clip)


def _rank(rank):
    from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
    torch.backends.cudnn.deterministic = True
    mesh_lib.init_distributed("cuda")
    mesh = mesh_lib.make_mesh("1x2")
    preds = {}
    for name, form in FORMS.items():
        layers.band_conv = form
        run = _episode(mesh)
        if name == "columns":
            # both ranks run the clip once more (its collectives pair up),
            # rank 0 with its allocator's history recorded
            if rank == 0:
                cs.peak_memory_by_block(torch, run, f"superslomo rank 0 of "
                                                    f"2, {name}")
            else:
                run()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        seconds = []
        for _ in range(CLIPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, pred = run()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated() - base
        preds[name] = pred.cpu()
        if rank == 0:
            diff = float((preds[name] - preds["padded"]).abs().max())
            print(f"[band_conv] {name}: peak {peak / 2**30:.3f} GiB above "
                  f"{base / 2**30:.3f}, s/clip "
                  f"{[round(s, 4) for s in seconds]}, max|pred - padded's| "
                  f"{diff:.3e}", flush=True)
        del run
    layers.band_conv = FORMS["padded"]
    torch.distributed.destroy_process_group()


def main():
    from meta_interpolation_tpu_torch.ops import _build
    from meta_interpolation_tpu_torch.parallel.launch import spawn
    print(cs.card_line(), flush=True)
    _build.build(["warp"])
    torch.backends.cudnn.deterministic = True
    cs.peak_memory_by_block(torch, _episode(None), "superslomo one process")
    spawn(_rank, 2, timeout=600)


if __name__ == "__main__":
    main()
