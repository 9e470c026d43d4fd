"""Time versions of csrc/flow_projection.cu against the checkout's K4 on one
CUDA card.

    python3 -m meta_interpolation_tpu_torch.tools.projection_variants \\
        [--sass DIR] [--no-check] NAME=PATH [NAME=PATH ...]

Run from the root of a checkout (it uses chip_smoke.py's helpers). Each
PATH is a version of csrc/flow_projection.cu with the same C interface: an
earlier commit's (``git show
<commit>:meta_interpolation_tpu_torch/csrc/flow_projection.cu``) or a design
under trial. Every version is built beside the checkout's kernels, one nvcc
each, all started together, and its registers and spill bytes are printed
(ptxas); with ``--sass DIR`` its SASS goes to ``DIR/<NAME>.sass`` and its
instruction counts by opcode are printed. Each version's proj and cnt must
be bitwise equal to the checkout's at every chip_smoke.py K4 check, and
each is timed in turns with the checkout's (this, version, version, this)
at DAIN's served shape on the uniform and the smooth flow of chip_smoke.py;
a version that fails to build or to agree is reported, skipped, and fails
the run at the end. ``--no-check`` skips the bitwise check, to time
versions that are not meant to agree: the kernel with a phase cut out, to
see what that phase costs.
"""
from __future__ import annotations

import argparse
import os

import torch

import chip_smoke as cs
from meta_interpolation_tpu_torch.ops import _build
from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
from meta_interpolation_tpu_torch.tools.sepconv_variants import sass_counts


def bitwise_equal_everywhere(version):
    """Raise unless ``version`` gives the checkout's proj and cnt bit for
    bit at every chip_smoke.PROJ_CASES entry, with and without depth."""
    for n, h, w, r, kind, span in cs.PROJ_CASES:
        flow = cs.proj_flow(torch, kind, n, h, w, span, n + h + w + r).cuda()
        depth = (torch.rand(n, h, w, 1) + 0.3).cuda()
        for d in (depth, None):
            got = version(flow, d, r)
            want = fpb.flow_projection_bounded(flow, d, r)
            cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                     f"{n}x{h}x{w} R={r} {kind} flow: not bitwise equal")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--sass", metavar="DIR")
    parser.add_argument("--no-check", action="store_true",
                        help="time the versions without holding them to "
                             "the checkout's results")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("projection_variants: no CUDA device")
    versions = dict(v.split("=", 1) for v in args.versions)
    card = cs.card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {name: cs.start_build(os.path.abspath(path), f"variant_{name}",
                                   "flow_projection")
              for name, path in versions.items()}
    log = _build.build(["flow_projection"])["flow_projection"]["log"]
    cs.kernel_resources(log, "this checkout", cs.PROJECTION_KERNELS,
                        no_spill=False)
    fns, failed = {}, []
    for name in versions:
        try:
            lib = cs.finish_build(fpb._bind, *builds[name], name,
                                  cs.PROJECTION_KERNELS)
            fns[name] = cs.on_library(fpb, lib, fpb.flow_projection_bounded)
            if not args.no_check:
                bitwise_equal_everywhere(fns[name])
        except AssertionError as err:
            fns.pop(name, None)
            failed.append(name)
            print(f"[variants] {name}: {err}")
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        libs = {"this": str(_build.library_path("flow_projection")),
                **{name: builds[name][1] for name in fns}}
        for name, lib in libs.items():
            for func, count in sass_counts(
                    lib, os.path.join(args.sass, f"{name}.sass")).items():
                print(f"[sass] {name} {func}: {sum(count.values())} "
                      f"instructions, {dict(count.most_common(14))}")

    n, (h, w), r = 1, cs.FULL_HW, cs.PROJ_R
    gen = torch.Generator().manual_seed(7)
    uniform = ((torch.rand(n, h, w, 2, generator=gen) * 2 - 1) * r).cuda()
    depth = (torch.rand(n, h, w, 1, generator=gen) + 0.3).cuda()
    smooth = cs.smooth_flow(torch, n, h, w, r, seed=8).cuda()
    for name, fn in fns.items():
        for label, flow in (("uniform", uniform), ("smooth", smooth)):
            t_this, t_them = cs.in_turns(torch, (
                lambda: fpb.flow_projection_bounded(flow, depth, r),
                lambda: fn(flow, depth, r)))
            print(f"[variants] K4 on the {label} flow, in turns (this, "
                  f"{name}, {name}, this): this {t_this[0]:.4f}, "
                  f"{t_this[1]:.4f} ms; {name} {t_them[0]:.4f}, "
                  f"{t_them[1]:.4f} ms")
    print(card)
    if failed:
        raise SystemExit(f"projection_variants: {failed} failed to build or "
                         f"to agree with the checkout")


if __name__ == "__main__":
    main()
