#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Run from a checkout: the port's package must sit beside this script. It
exits non-zero, printing no result, when there is no CUDA device or no
package; any failed check raises. Phases, in order:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under meta_interpolation_tpu_torch/csrc/;
  3. kernels: each held against its plain PyTorch version on the card at
     the SepConv shape (input 1x3x434x562, maps 1x51x384x512) and a ragged
     one, and timed beside that version and the card's bound;
  4. main path: the CLI's scene-adaptive evaluation of the 8 synthetic
     validation clips (crop 256, Adamax, Meta-SGD, 3 inner steps), then
     full 256x448 Vimeo-size clips through run_validation_iter, each run
     with the kernel launch counts checked; then a crop-64 clip on the card
     against the same clip on the CPU;
  5. a JSON line of per-kernel results, the card line again, and the last
     line {"ok": true, "device": {...}}.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "meta_interpolation_tpu_torch"
# kernel vs plain version: only the summation order differs
TOL_REL, TOL_ABS = 1e-4, 1e-5
# card vs CPU on one small clip, as the port's CPU tests hold it to JAX
PRED_ATOL, PSNR_TOL_DB = 1e-4, 1e-3
EVAL_FLAGS = ["--model", "sepconv", "--mode", "val", "--optimizer", "Adamax",
              "--metasgd", "--inner_lr", "1e-5",
              "--number_of_evaluation_steps_per_iter", "3",
              "--val_batch_size", "1", "--loss", "1*L1"]
STEPS, PAIRS, CALLS = 3, 2, 2   # inner steps, support pairs, sepconvs a pass
K1_PER_CLIP = PAIRS * CALLS * STEPS + CALLS   # support passes + the query
K2_PER_CLIP = PAIRS * CALLS * STEPS           # support backwards
KERNEL_SHAPES = [(37, 53), (384, 512)]  # (H, W) of the maps; timed: last
CLI_CROP = 256                 # synthetic clips of the CLI run
FULL_HW = (256, 448)           # the Vimeo frame (kernel maps 384x512)
SMALL_HW = (64, 64)            # card vs CPU
# data-sheet peaks: fp32 outside the tensor cores (FLOP/s) and device
# memory (bytes/s); first name that the card's name contains wins
PEAKS = [("H100 PCIe", 51.2e12, 2.0e12), ("H100 NVL", 60.0e12, 3.9e12),
         ("H100", 67.0e12, 3.35e12), ("H200", 67.0e12, 4.8e12)]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def peaks(name):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def time_ms(torch, fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want, what):
    err = (got - want).abs().max().item()
    lim = TOL_REL * want.abs().max().item() + TOL_ABS
    check(err <= lim, f"{what}: max|diff| {err:.3e} > {lim:.3e}")
    return err


def kernel_phase(torch, sc, card):
    """Hold K1/K2 against their plain versions; time both at the SepConv
    shape. Returns the per-kernel records (launches filled in later)."""
    flops_peak, bw_peak = peaks(card)
    errs = {"k1": 0.0, "k2": 0.0}
    for h, w in KERNEL_SHAPES:
        gen = torch.Generator().manual_seed(h * 1000 + w)
        f, c = 51, 3
        inp = torch.rand(1, c, h + f - 1, w + f - 1, generator=gen).cuda()
        kv = torch.randn(1, f, h, w, generator=gen).cuda()
        kh = torch.randn(1, f, h, w, generator=gen).cuda()
        g = torch.randn(1, c, h, w, generator=gen).cuda()
        out = sc.sepconv_forward(inp, kv, kh)
        errs["k1"] = max(errs["k1"], max_err(out, sc.sepconv_ref(inp, kv, kh),
                                             f"K1 {h}x{w}"))
        gkv, gkh = sc.sepconv_grad_kernels(inp, g, kv, kh)
        rkv, rkh = sc.grad_kernels_ref(inp, g, kv, kh)
        errs["k2"] = max(errs["k2"], max_err(gkv, rkv, f"K2 gkv {h}x{w}"),
                         max_err(gkh, rkh, f"K2 gkh {h}x{w}"))
        # the autograd Function against autograd through the plain forward
        grads = []
        for fn in (sc.sepconv, sc.sepconv_ref):
            leaves = [t.clone().requires_grad_() for t in (inp, kv, kh)]
            (fn(*leaves) * g).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b, name in zip(*grads, ("gin", "gkv", "gkh")):
            max_err(a, b, f"SepConvFunction {name} {h}x{w}")
        torch.cuda.synchronize()
        print(f"[kernels] {h}x{w}: K1 and K2 agree with the plain versions "
              f"(max|diff| K1 {errs['k1']:.3e}, K2 {errs['k2']:.3e})")

    n = 1
    k1_ops = 2 * n * h * w * c * f * (f + 1)
    k2_ops = 2 * n * h * w * f * f * (c + 2)
    in_bytes = 4 * n * c * (h + f - 1) * (w + f - 1)
    img_bytes, map_bytes = 4 * n * c * h * w, 4 * n * f * h * w
    k1_bytes = in_bytes + 2 * map_bytes + img_bytes
    k2_bytes = in_bytes + img_bytes + 4 * map_bytes
    records = []
    for name, err, fn, plain, ops, nbytes, line in [
            ("sepconv_forward", errs["k1"],
             lambda: sc.sepconv_forward(inp, kv, kh),
             lambda: sc.sepconv_ref(inp, kv, kh), k1_ops, k1_bytes, 134),
            ("sepconv_grad_kernels", errs["k2"],
             lambda: sc.sepconv_grad_kernels(inp, g, kv, kh),
             lambda: sc.grad_kernels_ref(inp, g, kv, kh), k2_ops, k2_bytes,
             233)]:
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/sepconv.cu",
            "replaces": f"meta_interpolation_tpu/ops/sepconv.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "shape": f"in 1x3x{h + f - 1}x{w + f - 1}, "
                                         f"maps 1x{f}x{h}x{w}",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        print(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
              f"bound {max(t_ops, t_bytes):.4f} ms by "
              f"{records[-1]['bound_by']}; no single PyTorch call computes "
              f"it, so library_ms is null)")
    return records


def device_time_by_kernel(torch, fn):
    """One run of ``fn`` under torch.profiler → (wall ms, device-busy ms,
    kernels sorted by device time). Only device events are summed: a host
    op's device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows


def main_path_phase(torch, sc):
    """The port's entry points on the card. Returns the launches of the
    CLI run (the main path) per kernel."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the CLI: the synthetic validation clips
    n_clips = len(SyntheticSeptuplet(mode="val"))
    sc.reset_launches()
    t0 = time.perf_counter()
    stats = port_main(EVAL_FLAGS + ["--dataset", "synthetic",
                                    "--crop_size", str(CLI_CROP)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"sepconv_forward": sc.sepconv_forward.launches,
                "sepconv_grad_kernels": sc.sepconv_grad_kernels.launches}
    check(math.isfinite(stats["psnr"]) and math.isfinite(stats["ssim"]),
          f"CLI metrics not finite: {stats}")
    check(launches == {"sepconv_forward": K1_PER_CLIP * n_clips,
                       "sepconv_grad_kernels": K2_PER_CLIP * n_clips},
          f"CLI launches {launches} for {n_clips} clips")
    print(f"[main] CLI val: {n_clips} clips at {CLI_CROP}x{CLI_CROP} in "
          f"{dt:.2f} s "
          f"(first clip includes set-up), PSNR {stats['psnr']:.3f} "
          f"SSIM {stats['ssim']:.4f}, launches {launches}")

    # (b) the full Vimeo frame
    cfg = get_args(EVAL_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    frames = SyntheticSeptuplet(mode="val", size=FULL_HW)[0][0][None]
    system.run_validation_iter(frames)  # warm-up: cuDNN plans, allocator
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, preds = system.run_validation_iter(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = (sc.sepconv_forward.launches, sc.sepconv_grad_kernels.launches)
    check(got == (K1_PER_CLIP * reps, K2_PER_CLIP * reps),
          f"{FULL_HW} launches {got} for {reps} clips")
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"{FULL_HW} output: {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] {FULL_HW[0]}x{FULL_HW[1]} episode: median {statistics.median(times):.4f} s "
          f"over {reps} (all {[round(t, 4) for t in times]}), PSNR "
          f"{losses['psnr']:.3f}, launches K1 {got[0] // reps} K2 "
          f"{got[1] // reps} per clip, peak memory {peak_gib:.2f} GiB")
    wall, busy, top = device_time_by_kernel(
        torch, lambda: system.run_validation_iter(frames))
    if busy > 0:
        ours = sum(ms for ms, _, key in top if "sepconv" in key)
        print(f"[profile] one {FULL_HW[0]}x{FULL_HW[1]} episode: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, sepconv "
              f"kernels {ours:.1f} ms ({ours / busy:.3f} of busy)")
        for ms, count, key in top[:12]:
            print(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    else:
        print("[profile] torch.profiler recorded no device time")

    # (c) a small clip on the card against the same clip on the CPU
    preds_by_dev, psnr_by_dev = {}, {}
    for dev in ("cuda", "cpu"):
        system = SceneAdaptiveInterpolation(cfg, device=dev)
        clip = SyntheticSeptuplet(mode="val", size=SMALL_HW)[0][0][None]
        losses, preds = system.run_validation_iter(clip)
        preds_by_dev[dev] = preds.cpu()
        psnr_by_dev[dev] = losses["psnr"]
    diff = (preds_by_dev["cuda"] - preds_by_dev["cpu"]).abs().max().item()
    dpsnr = abs(psnr_by_dev["cuda"] - psnr_by_dev["cpu"])
    check(diff <= PRED_ATOL and dpsnr <= PSNR_TOL_DB,
          f"card vs CPU at {SMALL_HW}: max|pred diff| {diff:.3e}, "
          f"PSNR diff {dpsnr:.3e} dB")
    print(f"[main] {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: max|pred diff| {diff:.3e}, "
          f"PSNR diff {dpsnr:.3e} dB")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meta_interpolation_tpu_torch.ops import _build
    from meta_interpolation_tpu_torch.ops import sepconv as sc

    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    report = _build.build()
    print(f"[build] {len(report)} source(s) in {time.perf_counter() - t0:.1f}"
          f" s")
    for name, rec in report.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for line in str(rec["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}")

    records = kernel_phase(torch, sc, card)
    launches = main_path_phase(torch, sc)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"{rec['name']} never ran on the main "
                                   f"path")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
