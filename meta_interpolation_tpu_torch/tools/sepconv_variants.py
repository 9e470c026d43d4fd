"""Time versions of csrc/sepconv.cu against the checkout's K1 and K2 on one
CUDA card.

    python3 -m meta_interpolation_tpu_torch.tools.sepconv_variants \\
        [--sass DIR] NAME=PATH [NAME=PATH ...]

Run from the root of a checkout (it uses chip_smoke.py's helpers). Each
PATH is a version of csrc/sepconv.cu with the same C interface: an earlier
commit's (``git show <commit>:meta_interpolation_tpu_torch/csrc/sepconv.cu``)
or a design under trial. Every version is built beside the checkout's
kernels, one nvcc each, all started together, and its registers and spill
bytes are printed (ptxas); with ``--sass DIR`` its SASS goes to
``DIR/<NAME>.sass`` and its instruction counts by opcode are printed, with
its tensor-core instructions (HMMA: mma.sync, HGMMA: wgmma) counted on a
line of their own. Each version's K1 and K2 are held against the plain
versions at the SepConv shape (maps 1x51x384x512), in float32 and, where
the version has bf16 entry points, in bf16 (within one bf16 ulp of max +
1e-5 of the plain versions on the same bf16 inputs), and timed in turns
with the checkout's (this, version, version, this), with chip_smoke.py's
card ms; a version that fails to build or to agree is reported, skipped,
and fails the run at the end. Last, the SM clock and the power are
sampled while the checkout's K1 and K2 run for a while.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import time

import torch

import chip_smoke as cs
from meta_interpolation_tpu_torch.ops import _build
from meta_interpolation_tpu_torch.ops import sepconv as sc


def sass_counts(lib: str, out_path: str | None):
    """Instruction counts by opcode of each kernel in ``lib``; the SASS is
    written to ``out_path`` where given."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(text)
    counts, func = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if m and func:
            counts[func][m.group(1)] += 1
    return counts


def sample_clocks(label, fn, seconds=1.5):
    """SM clock and power (nvidia-smi, every 100 ms) while ``fn`` runs."""
    torch.cuda.synchronize()
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader", "-lms", "100"], stdout=subprocess.PIPE,
        text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    proc.terminate()
    samples = proc.communicate()[0].strip().splitlines()
    print(f"[clocks] {label}: {samples[3:-1]}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("versions", nargs="+", metavar="NAME=PATH")
    parser.add_argument("--sass", metavar="DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sepconv_variants: no CUDA device")
    versions = dict(v.split("=", 1) for v in args.versions)
    card = cs.card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}")

    builds = {name: cs.start_build(os.path.abspath(path), f"variant_{name}",
                                   "sepconv")
              for name, path in versions.items()}
    log = _build.build(["sepconv"])["sepconv"]["log"]
    cs.sepconv_resources(log, "this checkout", no_spill=False)
    cs.kernel_resources(log, "this checkout", cs.BF16_SEPCONV_KERNELS,
                        no_spill=False)
    fns, has_bf16, failed = {}, {}, []
    for name in versions:
        try:
            with open(versions[name]) as fh:
                text = fh.read()
            # bf16 entry points; the tensor-core kernels' ptxas names
            has_bf16[name] = "sepconv_forward_bf16" in text
            lib = cs.finish_build(sc._bind, *builds[name], name, {
                **cs.SEPCONV_KERNELS,
                **(cs.BF16_SEPCONV_KERNELS
                   if "sepconv_fwd_bf16_kernel" in text else {})})
            fns[name] = (cs.on_library(sc, lib, sc.sepconv_forward),
                         cs.on_library(sc, lib, sc.sepconv_grad_kernels))
        except AssertionError as err:
            failed.append(name)
            print(f"[variants] {name}: {err}")
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        libs = {"this": str(_build.library_path("sepconv")),
                **{name: builds[name][1] for name in fns}}
        for name, lib in libs.items():
            for func, count in sass_counts(
                    lib, os.path.join(args.sass, f"{name}.sass")).items():
                print(f"[sass] {name} {func}: {sum(count.values())} "
                      f"instructions, {dict(count.most_common(12))}")
                print(f"[sass] {name} {func}: tensor cores HMMA "
                      f"{count['HMMA']}, HGMMA {count['HGMMA']}")

    n, h, w, f = cs.KERNEL_SHAPES[-1]
    gen = torch.Generator().manual_seed(1)
    inp = torch.rand(n, 3, h + f - 1, w + f - 1, generator=gen).cuda()
    kv, kh = (torch.randn(n, f, h, w, generator=gen).cuda() for _ in "vh")
    g = torch.randn(n, 3, h, w, generator=gen).cuda()
    ref = sc.sepconv_ref(inp, kv, kh)
    rkv, rkh = sc.grad_kernels_ref(inp, g, kv, kh)
    this = (lambda: sc.sepconv_forward(inp, kv, kh),
            lambda: sc.sepconv_grad_kernels(inp, g, kv, kh))
    b = [t.to(torch.bfloat16) for t in (inp, g, kv, kh)]
    b_ref = sc._widened(sc.sepconv_ref, b[0], b[2], b[3])
    b_rkv, b_rkh = sc._widened(sc.grad_kernels_ref, *b)
    b_this = (lambda: sc.sepconv_forward(b[0], b[2], b[3]),
              lambda: sc.sepconv_grad_kernels(*b))
    for name, (k1, k2) in fns.items():
        try:
            cs.max_err(k1(inp, kv, kh), ref, f"{name} K1")
            gkv, gkh = k2(inp, g, kv, kh)
            cs.max_err(gkv, rkv, f"{name} K2 gkv")
            cs.max_err(gkh, rkh, f"{name} K2 gkh")
        except AssertionError as err:
            failed.append(name)
            print(f"[variants] {name}: {err}")
            continue
        timings = [("K1", this[0], lambda: k1(inp, kv, kh)),
                   ("K2", this[1], lambda: k2(inp, g, kv, kh))]
        if has_bf16[name]:
            try:
                cs.bf16_err(k1(b[0], b[2], b[3]), b_ref, f"{name} K1 bf16")
                gkv, gkh = k2(*b)
                cs.bf16_err(gkv, b_rkv, f"{name} K2 gkv bf16")
                cs.bf16_err(gkh, b_rkh, f"{name} K2 gkh bf16")
            except AssertionError as err:
                failed.append(name)
                print(f"[variants] {name}: {err}")
                continue
            timings += [("K1 bf16", b_this[0], lambda: k1(b[0], b[2], b[3])),
                        ("K2 bf16", b_this[1], lambda: k2(*b))]
        for label, mine, theirs in timings:
            t_this, t_them = cs.in_turns(torch, (mine, theirs))
            print(f"[variants] {label} at maps {n}x{f}x{h}x{w}, in turns "
                  f"(this, {name}, {name}, this): this "
                  f"{t_this[0]:.4f}, {t_this[1]:.4f} ms; {name} "
                  f"{t_them[0]:.4f}, {t_them[1]:.4f} ms")
    sample_clocks("K1", this[0])
    sample_clocks("K2", this[1])
    print(card)
    if failed:
        raise SystemExit(f"sepconv_variants: {failed} failed to build or "
                         f"to agree with the plain versions")


if __name__ == "__main__":
    main()
