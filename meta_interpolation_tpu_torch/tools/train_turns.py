"""Seconds per SepConv train iteration of the checkout it runs in, at
chip_smoke.py's training preset (scripts/run_sepconv.sh: batch 3, 256x256
synthetic crops, 3 inner steps, Adamax, Meta-SGD, first order), to compare
checkouts in turns on one CUDA card.

    PYTHONPATH=. python3 PATH/TO/train_turns.py [--reps N]

Run it from the root of a checkout: the package and chip_smoke.py are
imported from there, so one copy of this file also times an earlier
checkout. Run it from each checkout in turns (earlier, this, this,
earlier, ...) within one call to the card. Prints one JSON line: the card's
name and power limit, the median and every time of N iterations after 2
warm-ups, peak memory, and the wall time, device-busy time and
cudaLaunchKernel count of one more iteration under torch.profiler.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics

import numpy as np
import torch

import chip_smoke as cs
from meta_interpolation_tpu_torch.config import get_args
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=cs.TRAIN_REPS)
    args = parser.parse_args(argv)
    clips = SyntheticSeptuplet(mode="train", size=(cs.CLI_CROP, cs.CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(cs.TASKS)])
    system = SceneAdaptiveInterpolation(get_args(cs.TRAIN_FLAGS))
    torch.cuda.reset_peak_memory_stats()

    def run():
        system.run_train_iter(frames, 0)

    times = cs.timed_iters(torch, run, args.reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall, busy, _, host = cs.device_time_by_kernel(torch, run)
    print(json.dumps({
        "card": cs.card_line(), "checkout": os.getcwd(),
        "median_s": statistics.median(times), "all_s": times,
        "peak_gib": peak, "profiled_wall_ms": wall, "busy_ms": busy,
        "cudaLaunchKernel": sum(count for _, count, key in host
                                if key == "cudaLaunchKernel")}))


if __name__ == "__main__":
    main()
