"""Time versions of csrc/warp.cu against the checkout's K3 and K3-grad on
one CUDA card.

    python3 -m meta_interpolation_tpu_torch.tools.warp_variants \\
        [--sass DIR] [--no-check] [NAME=PATH ...]

Run from the root of a checkout (it uses chip_smoke.py's helpers). Each
PATH is a version of csrc/warp.cu with the checkout's C interface (grid in,
output or grid gradient out): a design under trial, as an edited copy.
Every version is built beside the checkout's kernels, one nvcc each, all
started together, and its registers and spill bytes are printed (ptxas);
with ``--sass DIR`` its SASS goes to ``DIR/<NAME>.sass`` and its
instruction counts by opcode are printed. The checkout and each version
are held against the plain composition at every chip_smoke.py K3 check
(``warp_cases``), and each version is timed in turns with the checkout's
(this, version, version, this) at RRIN's padded frame (1x3x256x512, R = 8,
zeros, align_corners False) on two grids within range, one with random
displacements and one with smooth ones; a version that fails to
build or to agree is reported, skipped, and fails the run at the end.
``--no-check`` skips the checks of the versions, to time versions that are
not meant to agree: the kernel with a phase cut out, to see what that phase
costs.
"""
from __future__ import annotations

import argparse
import os

import torch

import chip_smoke as cs
from meta_interpolation_tpu_torch.ops import _build
from meta_interpolation_tpu_torch.ops import warp_bounded as wb
from meta_interpolation_tpu_torch.tools.sepconv_variants import sass_counts


def agrees_everywhere():
    """Raise unless the wrappers, as bound now, agree with the plain
    composition at every chip_smoke.py K3 check."""
    for case in cs.warp_cases():
        cs.warp_checks(torch, wb, case)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="*", metavar="NAME=PATH")
    parser.add_argument("--sass", metavar="DIR")
    parser.add_argument("--no-check", action="store_true",
                        help="time the versions without holding them to "
                             "the plain composition")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_variants: no CUDA device")
    versions = dict(v.split("=", 1) for v in args.versions)
    card = cs.card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {name: cs.start_build(os.path.abspath(path), f"variant_{name}",
                                   "warp")
              for name, path in versions.items()}
    log = _build.build(["warp"])["warp"]["log"]
    cs.kernel_resources(log, "this checkout", cs.WARP_KERNELS,
                        no_spill=False)
    agrees_everywhere()
    print(f"[variants] this checkout agrees at {len(cs.warp_cases())} "
          f"cases")
    fns, failed = {}, []
    for name in versions:
        try:
            lib = cs.finish_build(wb._bind, *builds[name], name,
                                  cs.WARP_KERNELS)
            fns[name] = (cs.on_library(wb, lib,
                                       wb.warp_sample_bounded_forward),
                         cs.on_library(wb, lib,
                                       wb.warp_sample_bounded_grad_grid))
            if not args.no_check:
                cs.on_library(wb, lib, agrees_everywhere)()
        except AssertionError as err:
            fns.pop(name, None)
            failed.append(name)
            print(f"[variants] {name}: {err}")
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        libs = {"this": str(_build.library_path("warp")),
                **{name: builds[name][1] for name in fns}}
        for name, lib in libs.items():
            for func, count in sass_counts(
                    lib, os.path.join(args.sass, f"{name}.sass")).items():
                print(f"[sass] {name} {func}: {sum(count.values())} "
                      f"instructions, {dict(count.most_common(14))}")

    n, c, (h, w), r = 1, 3, cs.WARP_SHAPES[-1][:2], cs.WARP_R
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    for kind, label in (("library", "random"), ("smooth", "smooth")):
        grid = cs.warp_grid(torch, kind, n, h, w, -r, r - 2, False, 6).cuda()
        args_fwd, args_grad = (img, grid, r), (img, grid, g, r)
        this = (lambda: wb.warp_sample_bounded_forward(*args_fwd),
                lambda: wb.warp_sample_bounded_grad_grid(*args_grad))
        for what, fn in zip(("K3", "K3-grad"), this):
            print(f"[variants] {what} this checkout, {label} grid: "
                  f"{cs.time_ms(torch, fn):.4f} ms, eager call "
                  f"{cs.call_ms(torch, fn):.4f} ms")
        for name, (fwd, grad) in fns.items():
            for what, mine, theirs in [
                    ("K3", this[0], lambda: fwd(*args_fwd)),
                    ("K3-grad", this[1], lambda: grad(*args_grad))]:
                t_this, t_them = cs.in_turns(torch, (mine, theirs))
                print(f"[variants] {what} at {n}x{c}x{h}x{w}, {label} grid, "
                      f"in turns (this, {name}, {name}, this): this "
                      f"{t_this[0]:.4f}, {t_this[1]:.4f} ms; {name} "
                      f"{t_them[0]:.4f}, {t_them[1]:.4f} ms")
    print(card)
    if failed:
        raise SystemExit(f"warp_variants: {failed} failed to build or to "
                         f"agree with the plain composition")


if __name__ == "__main__":
    main()
