#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check what comes out.

    python3 chip_smoke.py

Run from a checkout: the port's package must sit beside this script. It
exits non-zero, printing no result, when there is no CUDA device or no
package; any failed check raises. Phases, in order:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under meta_interpolation_tpu_torch/csrc/, one
     nvcc per source, all started together;
  3. kernels: each held against its plain PyTorch version on the card at
     its main-path shape and a ragged one, and timed beside that version,
     the card's bound and, where one exists, the one PyTorch call that
     computes the same function:
       - SepConv K1/K2 at input 1x3x434x562, maps 1x51x384x512;
       - the bounded warp K3 and its fy/fx gradient at image 1x3x256x512
         (RRIN's padded 256x448 frame), R = 8, floors over all of [-8, 7];
  4. main paths, each driven with every launch count set to 0 just before
     it and read just after:
       - SepConv: the CLI's scene-adaptive evaluation of the 8 synthetic
         validation clips (crop 256, Adamax, Meta-SGD, 3 inner steps), full
         256x448 Vimeo-size clips through run_validation_iter, and a
         crop-64 clip on the card against the same clip on the CPU;
       - RRIN: the same three with the run_rrin.sh hyperparameters (Adam,
         LSLR, 0 training steps) plus 1 evaluation step and
         --fast_warp_range 8, the 256x448 episodes timed in turns with
         episodes on the exact warp (F.grid_sample, no kernel launched),
         and the forward's FLOPs counted;
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
# RRIN: run_rrin.sh's hyperparameters, one evaluation step, bounded warp
WARP_R = 8
RRIN_FLAGS = ["--model", "rrin", "--mode", "val", "--optimizer", "Adam",
              "--inner_lr", "1e-5", "--loss", "1*L1",
              "--number_of_training_steps_per_iter", "0",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1", "--fast_warp_range", str(WARP_R)]
RRIN_STEPS, WARPS = 1, 2       # inner steps, warps a forward
RRIN_QUERY = (2, 3, 4)         # (in0, target, in1) of the query
K3_PER_CLIP = PAIRS * WARPS * RRIN_STEPS + WARPS   # support passes + query
K3G_PER_CLIP = PAIRS * WARPS * RRIN_STEPS          # support backwards
# (H, W, lowest floor, highest floor) of the warp checks; timed: last.
# The middle one reaches past [-R, R-1], where only the window masks act.
WARP_SHAPES = [(37, 53, -WARP_R, WARP_R - 1),
               (37, 53, -WARP_R - 3, WARP_R + 2),
               (256, 512, -WARP_R, WARP_R - 1)]
KERNELS = ("sepconv_forward", "sepconv_grad_kernels", "warp_bounded_forward",
           "warp_bounded_grad_frac")
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


def call_ms(torch, fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of one eager call of ``fn``
    after warm-up: the host's launch overhead included."""
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


def time_ms(torch, fn, reps=20, warmup=3, calls=20):
    """The card's time for one call of ``fn``: ``calls`` calls captured
    back to back in one CUDA graph after warm-up, then the median of
    ``reps`` CUDA-event timings of a replay, over ``calls``. Inside a
    replay the host launches nothing, so what is timed is the card's work
    and the small gaps between its kernels, not the host's launch
    overhead, which is most of an eager call of a microsecond kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return call_ms(torch, graph.replay, reps, warmup) / calls


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
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/sepconv.cu",
            "replaces": f"meta_interpolation_tpu/ops/sepconv.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "call_ms": eager_ms,
            "shape": f"in 1x3x{h + f - 1}x{w + f - 1}, maps 1x{f}x{h}x{w}",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        print(f"[kernels] {name}: {ms:.4f} ms, eager call {eager_ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms by "
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
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
        elif e.device_type == DeviceType.CPU:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows, host


def warp_kernel_phase(torch, wb, card):
    """Hold K3 and its fy/fx gradient against their plain versions; time
    both at the RRIN main-path shape. Returns the per-kernel records
    (launches filled in later)."""
    import torch.nn.functional as F
    flops_peak, bw_peak = peaks(card)
    r, n, c = WARP_R, 1, 3
    errs = {"fwd": 0.0, "frac": 0.0}
    for h, w, lo, hi in WARP_SHAPES:
        gen = torch.Generator().manual_seed(h * 1000 + w + hi)
        img = torch.rand(n, c, h, w, generator=gen).cuda()
        dy0, dx0 = (torch.randint(lo, hi + 1, (n, h, w), generator=gen,
                                  dtype=torch.int32).cuda() for _ in "yx")
        fy, fx = (torch.rand(n, h, w, generator=gen).cuda() for _ in "yx")
        g = torch.randn(n, c, h, w, generator=gen).cuda()
        what = f"{h}x{w} floors [{lo}, {hi}]"
        errs["fwd"] = max(errs["fwd"], max_err(
            wb.warp_bounded_forward(img, dy0, dx0, fy, fx, r),
            wb.warp_bounded_ref(img, dy0, dx0, fy, fx, r), f"K3 {what}"))
        got = wb.warp_bounded_grad_frac(img, dy0, dx0, fy, fx, g, r)
        want = wb.warp_bounded_grad_frac_ref(img, dy0, dx0, fy, fx, g, r)
        errs["frac"] = max(errs["frac"],
                           max_err(got[0], want[0], f"K3-grad gfy {what}"),
                           max_err(got[1], want[1], f"K3-grad gfx {what}"))
        # the autograd Function against autograd through the plain forward
        grads = []
        for fn in (wb.warp_bounded, wb.warp_bounded_ref):
            leaves = [t.clone().requires_grad_() for t in (img, fy, fx)]
            (fn(leaves[0], dy0, dx0, leaves[1], leaves[2], r) * g
             ).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b, name in zip(*grads, ("gimg", "gfy", "gfx")):
            max_err(a, b, f"WarpBoundedFunction {name} {what}")
        torch.cuda.synchronize()
        print(f"[kernels] {what}: K3 and K3-grad agree with the plain "
              f"versions (max|diff| K3 {errs['fwd']:.3e}, K3-grad "
              f"{errs['frac']:.3e})")

    # the library call that computes K3's function: border clamping of the
    # coordinate equals clamping each tap to the edge
    xs = torch.arange(w, device=img.device)[None, None, :] + dx0 + fx
    ys = torch.arange(h, device=img.device)[None, :, None] + dy0 + fy
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)
    library = lambda: F.grid_sample(img, grid, padding_mode="border",
                                    align_corners=True)
    max_err(library(), wb.warp_bounded_ref(img, dy0, dx0, fy, fx, r),
            "F.grid_sample (border) against K3's plain version")
    plane, image = 4 * n * h * w, 4 * n * c * h * w
    records = []
    for name, err, fn, plain, lib, ops, nbytes, replaces in [
            ("warp_bounded_forward", errs["fwd"],
             lambda: wb.warp_bounded_forward(img, dy0, dx0, fy, fx, r),
             lambda: wb.warp_bounded_ref(img, dy0, dx0, fy, fx, r), library,
             n * h * w * (9 * c + 6), 2 * image + 4 * plane,
             "meta_interpolation_tpu/ops/warp_pallas.py:86"),
            ("warp_bounded_grad_frac", errs["frac"],
             lambda: wb.warp_bounded_grad_frac(img, dy0, dx0, fy, fx, g, r),
             lambda: wb.warp_bounded_grad_frac_ref(img, dy0, dx0, fy, fx, g,
                                                   r), None,
             n * h * w * (22 * c + 6), 2 * image + 6 * plane,
             "meta_interpolation_tpu/ops/warp.py:310")]:
        ms = time_ms(torch, fn)
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        library_ms = time_ms(torch, lib) if lib is not None else None
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/warp.cu", "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "call_ms": eager_ms,
            "shape": f"img {n}x{c}x{h}x{w}, R={r}",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        lib_txt = (f"library F.grid_sample {library_ms:.4f} ms"
                   if library_ms is not None else
                   "no single PyTorch call computes it, so library_ms is "
                   "null")
        print(f"[kernels] {name}: {ms:.4f} ms, eager call {eager_ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
              f"by {records[-1]['bound_by']}; {lib_txt})")
    return records


def reset_launches(mods):
    for mod in mods:
        mod.reset_launches()


def launch_counts(mods):
    return {name: getattr(mod, name).launches for mod in mods
            for name in KERNELS if hasattr(mod, name)}


def profile_episode(torch, run, label, ours_key):
    """One episode under torch.profiler: wall, device busy, idle share,
    the share of the kernels whose names hold ``ours_key``, and the top
    kernels by device time."""
    wall, busy, top, host = device_time_by_kernel(torch, run)
    print(f"[profile] {label} host ops by self CPU time: " + "; ".join(
        f"{key} {ms:.1f} ms {count}x" for ms, count, key in host[:8]))
    if busy <= 0:
        print("[profile] torch.profiler recorded no device time")
        return
    ours = [row for row in top if ours_key in row[2]]
    ours_ms = sum(ms for ms, _, _ in ours)
    print(f"[profile] one {label} episode: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {ours_key} "
          f"kernels {ours_ms:.3f} ms ({ours_ms / busy:.4f} of busy)")
    for ms, count, key in top[:12] + [r for r in ours if r not in top[:12]]:
        print(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")


def card_vs_cpu(cfg, model):
    """The first small synthetic clip on the card and on the CPU."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    preds_by_dev, psnr_by_dev = {}, {}
    for dev in ("cuda", "cpu"):
        system = SceneAdaptiveInterpolation(cfg, device=dev)
        clip = SyntheticSeptuplet(model=model, mode="val",
                                  size=SMALL_HW)[0][0][None]
        losses, preds = system.run_validation_iter(clip)
        preds_by_dev[dev] = preds.cpu()
        psnr_by_dev[dev] = losses["psnr"]
    diff = (preds_by_dev["cuda"] - preds_by_dev["cpu"]).abs().max().item()
    dpsnr = abs(psnr_by_dev["cuda"] - psnr_by_dev["cpu"])
    check(diff <= PRED_ATOL and dpsnr <= PSNR_TOL_DB,
          f"{model} card vs CPU at {SMALL_HW}: max|pred diff| {diff:.3e}, "
          f"PSNR diff {dpsnr:.3e} dB")
    print(f"[main] {model} {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: "
          f"max|pred diff| {diff:.3e}, PSNR diff {dpsnr:.3e} dB")


def cli_phase(torch, mods, flags, model, per_clip):
    """The CLI on the synthetic validation clips at CLI_CROP, with every
    launch count set to 0 just before and checked against ``per_clip``
    times the clip count just after. Returns the counts."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    n_clips = len(SyntheticSeptuplet(mode="val"))
    reset_launches(mods)
    t0 = time.perf_counter()
    stats = port_main(flags + ["--dataset", "synthetic",
                               "--crop_size", str(CLI_CROP)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts(mods)
    check(math.isfinite(stats["psnr"]) and math.isfinite(stats["ssim"]),
          f"{model} CLI metrics not finite: {stats}")
    want = {k: per_clip.get(k, 0) * n_clips for k in launches}
    check(launches == want, f"{model} CLI launches {launches} for {n_clips} "
                            f"clips, want {want}")
    print(f"[main] {model} CLI val: {n_clips} clips at {CLI_CROP}x{CLI_CROP} "
          f"in {dt:.2f} s (first clip includes set-up), PSNR "
          f"{stats['psnr']:.3f} SSIM {stats['ssim']:.4f}, launches "
          f"{launches}")
    return launches


def main_path_phase(torch, mods):
    """SepConv through the port's entry points on the card. Returns the
    launches of the CLI run (the main path) per kernel."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the CLI: the synthetic validation clips
    launches = cli_phase(torch, mods, EVAL_FLAGS, "sepconv",
                         {"sepconv_forward": K1_PER_CLIP,
                          "sepconv_grad_kernels": K2_PER_CLIP})

    # (b) the full Vimeo frame
    cfg = get_args(EVAL_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    frames = SyntheticSeptuplet(mode="val", size=FULL_HW)[0][0][None]
    system.run_validation_iter(frames)  # warm-up: cuDNN plans, allocator
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, preds = system.run_validation_iter(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = launch_counts(mods)
    check(got["sepconv_forward"] == K1_PER_CLIP * reps
          and got["sepconv_grad_kernels"] == K2_PER_CLIP * reps,
          f"{FULL_HW} launches {got} for {reps} clips")
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"{FULL_HW} output: {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] sepconv {FULL_HW[0]}x{FULL_HW[1]} episode: median "
          f"{statistics.median(times):.4f} s over {reps} (all "
          f"{[round(t, 4) for t in times]}), PSNR {losses['psnr']:.3f}, "
          f"launches K1 {got['sepconv_forward'] // reps} K2 "
          f"{got['sepconv_grad_kernels'] // reps} per clip, peak "
          f"memory {peak_gib:.2f} GiB")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"sepconv {FULL_HW[0]}x{FULL_HW[1]}", "sepconv")

    # (c) a small clip on the card against the same clip on the CPU
    card_vs_cpu(cfg, "sepconv")
    return launches


def rrin_phase(torch, mods):
    """RRIN through the port's entry points on the card, bounded warp.
    Returns the launches of the CLI run (the main path) per kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the CLI: the synthetic validation clips
    launches = cli_phase(torch, mods, RRIN_FLAGS, "rrin",
                         {"warp_bounded_forward": K3_PER_CLIP,
                          "warp_bounded_grad_frac": K3G_PER_CLIP})

    # (b) the full Vimeo frame: the bounded warp, and the exact warp timed
    # in turns with it (bounded, exact, exact, bounded, ...)
    frames = SyntheticSeptuplet(model="rrin", mode="val",
                                size=FULL_HW)[0][0][None]
    systems = {"bounded": SceneAdaptiveInterpolation(get_args(RRIN_FLAGS))}
    torch.cuda.reset_peak_memory_stats()
    systems["bounded"].run_validation_iter(frames)  # warm-up
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    systems["exact"] = SceneAdaptiveInterpolation(
        get_args(RRIN_FLAGS + ["--fast_warp_range", "0"]))
    check(systems["exact"].model.warp_range is None,
          "exact path still bounded")
    systems["exact"].run_validation_iter(frames)  # warm-up
    reps = 4
    times = {"bounded": [], "exact": []}
    out = {}
    reset_launches(mods)
    for which in ["bounded", "exact", "exact", "bounded"] * (reps // 2):
        before = launch_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[which] = systems[which].run_validation_iter(frames)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        if which == "exact":
            check(launch_counts(mods) == before,
                  f"exact-warp episode launched kernels: {before} → "
                  f"{launch_counts(mods)}")
    got = launch_counts(mods)
    check(got["warp_bounded_forward"] == K3_PER_CLIP * reps
          and got["warp_bounded_grad_frac"] == K3G_PER_CLIP * reps,
          f"rrin {FULL_HW} launches {got} for {reps} clips")
    for which, (losses, preds) in out.items():
        check(tuple(preds.shape) == (1, 3) + FULL_HW
              and bool(torch.isfinite(preds).all())
              and math.isfinite(losses["psnr"]),
              f"rrin {FULL_HW} {which} output: {losses}")
    diff = (out["bounded"][1] - out["exact"][1]).abs().max().item()
    for which in times:
        extra = (f"launches K3 {got['warp_bounded_forward'] // reps} K3-grad "
                 f"{got['warp_bounded_grad_frac'] // reps} per clip, peak "
                 f"memory {peak_gib:.2f} GiB" if which == "bounded" else
                 f"F.grid_sample; bounded vs exact max|pred diff| {diff:.3e}")
        print(f"[main] rrin {FULL_HW[0]}x{FULL_HW[1]} episode, {which} warp"
              f"{f' R={WARP_R}' if which == 'bounded' else ''}: median "
              f"{statistics.median(times[which]):.4f} s over {reps} in turns "
              f"(all {[round(t, 4) for t in times[which]]}), PSNR "
              f"{out[which][0]['psnr']:.3f}, {extra}")
    profile_episode(torch,
                    lambda: systems["bounded"].run_validation_iter(frames),
                    f"rrin {FULL_HW[0]}x{FULL_HW[1]}", "warp_bounded")
    clip =systems["bounded"]._frames(frames)[0]
    q0, _, q1 = RRIN_QUERY
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        systems["bounded"].model(clip[q0][None], clip[q1][None])
    print(f"[main] rrin forward at {FULL_HW[0]}x{FULL_HW[1]}: "
          f"{counter.get_total_flops() / 1e9:.3f} GFLOP "
          f"(torch.utils.flop_counter)")

    # (c) a small clip on the card against the same clip on the CPU
    card_vs_cpu(get_args(RRIN_FLAGS), "rrin")
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
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb

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

    records = kernel_phase(torch, sc, card) + warp_kernel_phase(torch, wb,
                                                                card)
    mods = (sc, wb)
    sepconv_launches = main_path_phase(torch, mods)
    rrin_launches = rrin_phase(torch, mods)
    # each kernel's launches on the main path that runs it
    launches = {**{k: sepconv_launches[k] for k in KERNELS[:2]},
                **{k: rrin_launches[k] for k in KERNELS[2:]}}
    check([rec["name"] for rec in records] == list(KERNELS),
          f"kernel records {[rec['name'] for rec in records]}")
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
