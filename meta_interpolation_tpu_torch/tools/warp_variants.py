"""Time versions of csrc/warp.cu against the checkout's K3, K3-grad and
K3-grad² on one CUDA card, in float32 and in bf16.

    python3 -m meta_interpolation_tpu_torch.tools.warp_variants \\
        [--sass DIR] [--no-check] [--tile TH,TW,PAIRS ...] [NAME=PATH ...]

Run from the root of a checkout (it uses chip_smoke.py's helpers). Each
PATH is a version of csrc/warp.cu with the checkout's C interface (grid in,
output or grid gradient out; bf16 tile and gather entry points): a design
under trial, as an edited copy. ``--tile TH,TW,PAIRS`` adds the checkout's
source with the bf16 tile kernels' kTileH, kTileW and kPairs set so (a
block of TH x TW pixels, PAIRS pixel pairs a thread), written under
build/warp_variants/. Every version is built beside the checkout's
kernels, one nvcc each, all started together, and its registers, spill
bytes and static shared memory are printed (ptxas); with ``--sass DIR``
its SASS goes to ``DIR/<NAME>.sass`` and its instruction counts by opcode
are printed. The checkout is held against the plain composition at every
chip_smoke.py K3 check (``warp_cases``), and each version too; in bf16
each version is held bit for bit to the checkout's bf16 K3, K3-grad and
K3-grad² at every K3 check and the gather route's (``BF16_GATHER_CASES``).
Each version is timed in turns with the checkout's (this, version,
version, this): K3 and K3-grad in float32 at RRIN's padded frame
(1x3x256x512, R = 8, zeros, align_corners False) on two grids within
range, one with random displacements and one with smooth ones, and in
bf16 at that frame and at RRIN's served batch (8x3x256x512) on the random
one, where the checkout's tile kernels are also timed in turns with its
gather kernels; K3-grad² in float32 and bf16 at chip_smoke.py's
GRAD2_SHAPES and at 1x3x256x256, where the checkout's bf16 K3-grad² is
also timed in turns with the float32 one on the widened operands. A
version that fails to build or to agree is reported, skipped, and fails
the run at the end. ``--no-check`` skips the checks of the versions, to
time versions that are not meant to agree: the kernel with a phase cut
out, to see what that phase costs.
"""
from __future__ import annotations

import argparse
import os
import re

import torch

import chip_smoke as cs
from meta_interpolation_tpu_torch.ops import _build
from meta_interpolation_tpu_torch.ops import warp_bounded as wb
from meta_interpolation_tpu_torch.tools.sepconv_variants import sass_counts

TILE_CONSTANTS = ("kTileH", "kTileW", "kPairs")
# K3-grad² timed at chip_smoke.py's shapes and at one 256x256 image (the
# second-order main paths' crop)
GRAD2_SHAPES = cs.GRAD2_SHAPES + [
    ("1x3x256x256 random", 1, 3, 256, 256, "library", cs.WARP_R, False,
     "zeros")]


def agrees_everywhere():
    """Raise unless the wrappers, as bound now, agree with the plain
    composition at every chip_smoke.py K3 check."""
    for case in cs.warp_cases():
        cs.warp_checks(torch, wb, case)


def bf16_cases():
    return cs.warp_cases() + cs.BF16_GATHER_CASES


def bf16_outputs():
    """The bf16 K3, K3-grad and K3-grad² of the wrappers, as bound now, at
    every bf16_cases() entry."""
    outs = []
    for i, case in enumerate(bf16_cases()):
        img, g, v, grid, opts, what = cs.bf16_warp_inputs(torch, case, i)
        outs.append((what, wb.warp_sample_bounded_forward(img, grid, *opts),
                     wb.warp_sample_bounded_grad_grid(img, grid, g, *opts),
                     *wb.warp_sample_bounded_grad_grid_backward(
                         img, grid, g, v, *opts)))
    return outs


def tile_source(values):
    """The checkout's csrc/warp.cu with the bf16 tile kernels' constants
    TILE_CONSTANTS set to ``values``, written under build/warp_variants/:
    (name, path)."""
    text = (_build.CSRC / "warp.cu").read_text()
    for const, value in zip(TILE_CONSTANTS, values):
        text, hits = re.subn(rf"(constexpr int {const} = )\d+;",
                             rf"\g<1>{value};", text)
        if hits != 1:
            raise SystemExit(f"warp_variants: no {const} in csrc/warp.cu")
    name = "tile_" + "x".join(map(str, values))
    path = os.path.join(cs.ROOT, "build", "warp_variants", f"{name}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return name, path


def grad2_in_turns(libs, card):
    """K3-grad² of the checkout (chip_smoke.grad2_timing: bf16 in turns
    with the float32 kernel on the widened operands), then in turns with
    each version's, float32 and bf16, at GRAD2_SHAPES."""
    cs.grad2_timing(torch, wb, card, GRAD2_SHAPES)
    fn = wb.warp_sample_bounded_grad_grid_backward
    for label, n, c, h, w, kind, r, align, padding in GRAD2_SHAPES:
        img, grid, g, v = cs.grad2_inputs(torch, n, c, h, w, kind, r, align)
        opts = (r, align, padding)
        for dtype in (torch.float32, torch.bfloat16):
            im, gr = img.to(dtype), g.to(dtype)
            this = lambda im=im, gr=gr: fn(im, grid, gr, v, *opts)
            for name, lib in libs.items():
                t_this, t_them = cs.in_turns(torch, (
                    this, cs.on_library(wb, lib, this)))
                print(f"[variants] K3-grad² {str(dtype)[6:]} at {label}, "
                      f"in turns (this, {name}, {name}, this): this "
                      f"{t_this[0]:.4f}, {t_this[1]:.4f} ms; {name} "
                      f"{t_them[0]:.4f}, {t_them[1]:.4f} ms")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="*", metavar="NAME=PATH")
    parser.add_argument("--sass", metavar="DIR")
    parser.add_argument("--no-check", action="store_true",
                        help="time the versions without holding them to "
                             "the plain composition or the checkout")
    parser.add_argument("--tile", action="append", default=[],
                        metavar="TH,TW,PAIRS",
                        help="the checkout's source with the bf16 tile "
                             "kernels' kTileH, kTileW and kPairs set so")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("warp_variants: no CUDA device")
    versions = dict(v.split("=", 1) for v in args.versions)
    versions.update(tile_source(tuple(int(x) for x in t.split(",")))
                    for t in args.tile)
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
    ref_bf16 = bf16_outputs()
    print(f"[variants] this checkout agrees at {len(cs.warp_cases())} "
          f"cases")
    libs, failed = {}, []
    for name in versions:
        try:
            lib = cs.finish_build(wb._bind, *builds[name], name,
                                  cs.WARP_KERNELS)
            if not args.no_check:
                cs.on_library(wb, lib, agrees_everywhere)()
                for ref, got in zip(
                        ref_bf16, cs.on_library(wb, lib, bf16_outputs)()):
                    for part, a, b in zip(("K3", "K3-grad", "K3-grad² gg",
                                           "K3-grad² grid"), got[1:],
                                          ref[1:]):
                        cs.bitwise(torch, a, b, f"{name} {part} {ref[0]}")
                print(f"[variants] {name} agrees at {len(cs.warp_cases())} "
                      f"cases, and in bf16 bit for bit the checkout at "
                      f"{len(bf16_cases())}")
            libs[name] = lib
        except AssertionError as err:
            failed.append(name)
            print(f"[variants] {name}: {err}")
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        paths = {"this": str(_build.library_path("warp")),
                 **{name: builds[name][1] for name in libs}}
        for name, lib in paths.items():
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
        for name, lib in libs.items():
            for what, mine in zip(("K3", "K3-grad"), this):
                t_this, t_them = cs.in_turns(torch, (
                    mine, cs.on_library(wb, lib, mine)))
                print(f"[variants] {what} at {n}x{c}x{h}x{w}, {label} grid, "
                      f"in turns (this, {name}, {name}, this): this "
                      f"{t_this[0]:.4f}, {t_this[1]:.4f} ms; {name} "
                      f"{t_them[0]:.4f}, {t_them[1]:.4f} ms")
    # bf16: the checkout's tile kernels against its gather ones, then
    # against each version's
    cs.bf16_warp_timing(torch, wb, card)
    for name, lib in libs.items():
        cs.bf16_warp_timing(torch, wb, card, lib, name)
    grad2_in_turns(libs, card)
    print(card)
    if failed:
        raise SystemExit(f"warp_variants: {failed} failed to build or to "
                         f"agree")


if __name__ == "__main__":
    main()
