#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--earlier-sepconv PATH] [--earlier-projection PATH]
                          [--earlier-warp PATH]

Run from a checkout: the port's package must sit beside this script. It
exits non-zero, printing no result, when there is no CUDA device or no
package; any failed check raises. ``--earlier-sepconv``,
``--earlier-projection`` and ``--earlier-warp`` name an earlier version of
csrc/sepconv.cu, csrc/flow_projection.cu or csrc/warp.cu (e.g. from ``git
show <commit>:meta_interpolation_tpu_torch/csrc/sepconv.cu``): it is built
beside the kernels and timed in turns with them. The first two take the
checkout's C interface; the third takes the interface before the warp
kernels took the grid (K3 and its fy/fx gradient on coordinate planes),
and runs inside the plain glue of ``ops/warp_bounded.py``
(``grid_sample_bounded_ref``), as that tree did. Phases, in order:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under meta_interpolation_tpu_torch/csrc/, one
     nvcc per source, all started together; the registers and spill bytes
     of each kernel (ptxas), and no spill allowed;
  3. kernels: each held against its plain PyTorch version on the card at
     its main-path shape and ragged ones, and timed beside that version,
     the card's bound and, where one exists, the one PyTorch call that
     computes the same function:
       - SepConv K1/K2 at input 1x3x434x562, maps 1x51x384x512, and at
         edges of their tiles and strips: N = 2, F = 5 and F = 50, maps
         37x53 and 21x70;
       - the bounded grid sampler K3 and its grid gradient K3-grad at image
         1x3x256x512 (RRIN's padded 256x448 frame) and 37x53, both padding
         modes, both align_corners, R = 1, 3 and 8, displacements within
         and past R, on whole pixels and off every edge; both also against
         F.grid_sample and aten.grid_sampler_2d_backward within range;
       - the bounded flow projection K4 at 1x256x448 (DAIN's served frame),
         R = 8, on a uniform and a smooth flow, and at 2x37x53 with R = 0,
         1, 16 (over 48 KB of shared memory) and 40 (a halo staged in
         bands), flows past R, integer landings on the bottom and right
         edges, every source sent to one cell and every source of a tile
         to one tile row; with and without depth; two calls must be
         bitwise equal, and with --earlier-projection the earlier design's
         proj and cnt too;
  4. main paths, each driven with every launch count set to 0 just before
     it and read just after:
       - SepConv: the CLI's scene-adaptive evaluation of the 8 synthetic
         validation clips (crop 256, Adamax, Meta-SGD, 3 inner steps), full
         256x448 Vimeo-size clips through run_validation_iter, and a
         crop-64 clip on the card against the same clip on the CPU;
       - RRIN: the same three with the run_rrin.sh hyperparameters (Adam,
         LSLR, 0 training steps) plus 1 evaluation step and
         --fast_warp_range 8, the 256x448 episodes timed in turns with
         episodes on the exact warp (F.grid_sample, no kernel launched) and,
         with --earlier-warp, the earlier warp; the device time and device
         ops of one warp call (forward and flow gradient) and of an episode
         on each path; the forward's FLOPs counted;
       - DAIN: a served 256x448 frame with the bounded projection (K4 also
         timed on the two flows that frame projects), in turns with the
         exact one; the CLI and an episode (exact projection, as the JAX
         meta system); a 64x64 clip on the card against the CPU, and a
         served 64x64 frame on the card against the CPU given the card's
         flows, depths and offsets;
  5. a JSON line of per-kernel results, the card line again, and the last
     line {"ok": true, "device": {...}}.
"""
import argparse
import json
import math
import os
import re
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
# (N, H, W, F) of the K1/K2 checks; timed: last. H and W off the 16x16 and
# 16x8 tiles and the 4- and 2-pixel strips; F odd, even and small
KERNEL_SHAPES = [(1, 37, 53, 51), (2, 21, 70, 51), (2, 21, 70, 5),
                 (1, 37, 53, 50), (1, 384, 512, 51)]
# ptxas names of the K1/K2 kernels in csrc/sepconv.cu and of K4 in
# csrc/flow_projection.cu
SEPCONV_KERNELS = {"sepconv_forward": "sepconv_fwd_kernel",
                   "sepconv_grad_kernels": "sepconv_grad_kernels_kernel"}
PROJECTION_KERNELS = {"flow_projection_bounded": "flow_projection_kernel"}
CLI_CROP = 256                 # synthetic clips of the CLI run
FULL_HW = (256, 448)           # the Vimeo frame (kernel maps 384x512)
SMALL_HW = (64, 64)            # card vs CPU
# RRIN: run_rrin.sh's hyperparameters, one evaluation step, bounded warp
WARP_R = 8
WARP_RANGES = (1, 3, WARP_R)   # R of the K3 checks at the ragged shapes
RRIN_FLAGS = ["--model", "rrin", "--mode", "val", "--optimizer", "Adam",
              "--inner_lr", "1e-5", "--loss", "1*L1",
              "--number_of_training_steps_per_iter", "0",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1", "--fast_warp_range", str(WARP_R)]
RRIN_STEPS, WARPS = 1, 2       # inner steps, warps a forward
RRIN_QUERY = (2, 3, 4)         # (in0, target, in1) of the query
K3_PER_CLIP = PAIRS * WARPS * RRIN_STEPS + WARPS   # support passes + query
K3G_PER_CLIP = PAIRS * WARPS * RRIN_STEPS          # support backwards
# (H, W, lowest floor, highest floor) of the displacements of the warp
# checks' grids; timed: last. The middle one reaches past [-R, R-1], where
# the clamp acts.
WARP_SHAPES = [(37, 53, -WARP_R, WARP_R - 1),
               (37, 53, -WARP_R - 3, WARP_R + 2),
               (256, 512, -WARP_R, WARP_R - 1)]
# ptxas names of K3 and K3-grad in csrc/warp.cu, and of the kernels of the
# warp.cu that took coordinate planes (--earlier-warp)
WARP_KERNELS = {"warp_sample_bounded_forward": "warp_sample_fwd_kernel",
                "warp_sample_bounded_grad_grid": "warp_sample_grad_grid_kernel"}
EARLIER_WARP_KERNELS = {"warp_bounded_forward": "warp_bounded_fwd_kernel",
                        "warp_bounded_grad_frac":
                            "warp_bounded_grad_frac_kernel"}
# DAIN: served at 256x448 with the bounded projection; the CLI with the
# run_dain.sh hyperparameters (no --dataset hd, no --resume) and tamed
# random weights
PROJ_R, DAIN_SEED = 8, 12345
# (N, H, W, R, flow, span) of the K4 checks (flows of proj_flow); timed:
# the first two, DAIN's served shape
PROJ_CASES = [(1, 256, 448, PROJ_R, "uniform", PROJ_R),
              (1, 256, 448, PROJ_R, "smooth", PROJ_R),
              (2, 37, 53, PROJ_R, "uniform", 11),    # past R: some dropped
              (2, 37, 53, 0, "uniform", 2),
              (2, 37, 53, 1, "uniform", 3),
              (2, 37, 53, 16, "uniform", 18),        # over 48 KB shared
              (2, 37, 53, 40, "uniform", 42),        # a halo in bands
              (2, 37, 53, PROJ_R, "integer", PROJ_R + 1),
              (2, 37, 53, PROJ_R, "one_cell", 0),
              (2, 37, 53, PROJ_R, "one_row", 0)]
DAIN_QUERY = (2, 4)                # the served pair: frames 2 and 4
K4_PER_FRAME = 2                   # one projection a direction
DAIN_PTH = os.path.join(ROOT, "build", "dain_tamed.pth")
DAIN_FLAGS = ["--model", "dain", "--mode", "val", "--optimizer", "Adamax",
              "--metasgd", "--inner_lr", "1e-5", "--loss", "1*L1",
              "--number_of_training_steps_per_iter", "1",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1", "--pretrained_model", DAIN_PTH]
# card vs CPU: a pixel may exceed the limit only within the reach, in
# pixels along each axis, of where a flow value near an integer (a floor
# flip) acts: the 2x2 cells a projected source lands on (1), the 4x4 filter
# window (2) and the rectify net's 21x21 receptive field (10)
NEAR_INT, FLIP_REACH = 1e-5, 13
KERNELS = ("sepconv_forward", "sepconv_grad_kernels",
           "warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
           "flow_projection_bounded")
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


def ptxas_report(log):
    """{entry function: {"registers", "spill", "stack"}} from the log of
    ``nvcc -Xptxas -v``; spill counts the bytes stored and loaded."""
    report, name = {}, None
    for line in str(log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name]["stack"] = int(m.group(1))
            report[name]["spill"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
    return report


def kernel_resources(log, what, entries, no_spill=True):
    """The registers and spill and stack bytes of the kernels ``entries``
    names ({wrapper: ptxas entry name}) from the build log of a source,
    the most over a template's instances; None where this run reused a
    built library. Fails on a spill if ``no_spill``: the kernels are
    designed to keep their state in registers."""
    report = ptxas_report(log)
    if not report:
        print(f"[build] {what}: library reused, no ptxas report")
        return None
    resources = {}
    for name, entry in entries.items():
        hits = [v for k, v in report.items() if entry in k]
        check(hits and all(len(hit) == 3 for hit in hits),
              f"{what}: no ptxas report for {entry}")
        res = resources[name] = {key: max(hit[key] for hit in hits)
                                 for key in hits[0]}
        print(f"[build] {what} {name}: {res['registers']} registers, "
              f"{res['spill']} bytes spilled, {res['stack']} bytes stack")
        check(not no_spill or res["spill"] == 0,
              f"{what} {name} spills {res['spill']} bytes")
    return resources


def sepconv_resources(log, what, no_spill=True):
    """K1's and K2's resources from the build log of a sepconv source."""
    return kernel_resources(log, what, SEPCONV_KERNELS, no_spill)


def with_attr(mod, name, value, fn):
    """``fn`` run with ``mod.<name>`` set to ``value``, restored after."""
    def run(*args):
        real = getattr(mod, name)
        setattr(mod, name, value)
        try:
            return fn(*args)
        finally:
            setattr(mod, name, real)
    return run


def on_library(mod, lib, fn):
    """``fn`` run with the wrappers of ``mod`` (ops/sepconv.py or
    ops/flow_projection_bounded.py) bound to ``lib``, a built version of
    their source (an earlier design, timed beside the kernels the port
    runs) in place of the checkout's."""
    return with_attr(mod, "_library", lambda: lib, fn)


def start_build(path, tag, source):
    """Start nvcc on a version of csrc/<source>.cu into build/<tag>/, with
    the kernels' own flags: (process, library path)."""
    from meta_interpolation_tpu_torch.ops import _build
    lib = os.path.join(ROOT, "build", tag, f"lib{source}.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                             path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_build(bind, proc, lib, what, entries):
    """Wait for start_build's nvcc, report the resources of its kernels
    ``entries`` and load it with the C signatures that ``bind`` sets (a
    wrapper module's ``_bind``)."""
    import ctypes
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"{what} build failed:\n{log}")
    kernel_resources(log, what, entries, no_spill=False)
    return bind(ctypes.CDLL(lib))


def in_turns(torch, fns, timer=None):
    """``timer`` (time_ms unless given) of the two ``fns`` in turns (first,
    second, second, first): one list of times per function."""
    timer = timer or time_ms
    times = ([], [])
    for i in (0, 1, 1, 0):
        times[i].append(timer(torch, fns[i]))
    return times


def kernel_phase(torch, sc, card, resources=None, earlier_lib=None):
    """Hold K1/K2 against their plain versions at every KERNEL_SHAPES
    entry; time both at the SepConv shape, in turns with the K1 and K2 of
    ``earlier_lib`` (an earlier design) where given. Returns the per-kernel
    records (launches filled in later)."""
    flops_peak, bw_peak = peaks(card)
    earlier = None if earlier_lib is None else (
        on_library(sc, earlier_lib, sc.sepconv_forward),
        on_library(sc, earlier_lib, sc.sepconv_grad_kernels))
    errs = {"k1": 0.0, "k2": 0.0}
    for n, h, w, f in KERNEL_SHAPES:
        gen = torch.Generator().manual_seed(n * 100000 + h * 1000 + w + f)
        c = 3
        inp = torch.rand(n, c, h + f - 1, w + f - 1, generator=gen).cuda()
        kv = torch.randn(n, f, h, w, generator=gen).cuda()
        kh = torch.randn(n, f, h, w, generator=gen).cuda()
        g = torch.randn(n, c, h, w, generator=gen).cuda()
        what = f"{n}x{h}x{w} F={f}"
        ref = sc.sepconv_ref(inp, kv, kh)
        errs["k1"] = max(errs["k1"], max_err(sc.sepconv_forward(inp, kv, kh),
                                             ref, f"K1 {what}"))
        gkv, gkh = sc.sepconv_grad_kernels(inp, g, kv, kh)
        rkv, rkh = sc.grad_kernels_ref(inp, g, kv, kh)
        errs["k2"] = max(errs["k2"], max_err(gkv, rkv, f"K2 gkv {what}"),
                         max_err(gkh, rkh, f"K2 gkh {what}"))
        # the autograd Function against autograd through the plain forward
        grads = []
        for fn in (sc.sepconv, sc.sepconv_ref):
            leaves = [t.clone().requires_grad_() for t in (inp, kv, kh)]
            (fn(*leaves) * g).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b, name in zip(*grads, ("gin", "gkv", "gkh")):
            max_err(a, b, f"SepConvFunction {name} {what}")
        torch.cuda.synchronize()
        print(f"[kernels] {what}: K1 and K2 agree with the plain versions "
              f"(max|diff| K1 {errs['k1']:.3e}, K2 {errs['k2']:.3e})")

    k1_ops = 2 * n * h * w * c * f * (f + 1)
    k2_ops = 2 * n * h * w * f * f * (c + 2)
    in_bytes = 4 * n * c * (h + f - 1) * (w + f - 1)
    img_bytes, map_bytes = 4 * n * c * h * w, 4 * n * f * h * w
    k1_bytes = in_bytes + 2 * map_bytes + img_bytes
    k2_bytes = in_bytes + img_bytes + 4 * map_bytes
    if earlier is not None:
        max_err(earlier[0](inp, kv, kh), ref, "earlier K1")
        for a, b, part in zip(earlier[1](inp, g, kv, kh), (rkv, rkh),
                              ("gkv", "gkh")):
            max_err(a, b, f"earlier K2 {part}")
    records = []
    for i, (name, err, fn, plain, ops, nbytes, line) in enumerate([
            ("sepconv_forward", errs["k1"],
             lambda: sc.sepconv_forward(inp, kv, kh),
             lambda: sc.sepconv_ref(inp, kv, kh), k1_ops, k1_bytes, 134),
            ("sepconv_grad_kernels", errs["k2"],
             lambda: sc.sepconv_grad_kernels(inp, g, kv, kh),
             lambda: sc.grad_kernels_ref(inp, g, kv, kh), k2_ops, k2_bytes,
             233)]):
        ms = time_ms(torch, fn)
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        bound = max(t_ops, t_bytes)
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/sepconv.cu",
            "replaces": f"meta_interpolation_tpu/ops/sepconv.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "call_ms": eager_ms,
            "shape": f"in {n}x3x{h + f - 1}x{w + f - 1}, maps {n}x{f}x{h}x{w}",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        res = (resources or {}).get(name)
        res_txt = (f"{res['registers']} registers, {res['spill']} bytes "
                   f"spilled" if res else "registers not reported")
        print(f"[kernels] {name}: {ms:.4f} ms, eager call {eager_ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {bound:.4f} ms by "
              f"{records[-1]['bound_by']}, {bound / ms:.3f} of the bound "
              f"reached; {res_txt}; no single PyTorch call computes it, so "
              f"library_ms is null)")
        if earlier is None:
            print(f"[kernels] {name}: earlier design not given "
                  f"(--earlier-sepconv)")
            continue
        args = (inp, kv, kh) if i == 0 else (inp, g, kv, kh)
        new, old = in_turns(torch, (fn, lambda: earlier[i](*args)))
        print(f"[kernels] {name}, in turns (this, earlier, earlier, this): "
              f"this design {new[0]:.4f}, {new[1]:.4f} ms; earlier design "
              f"{old[0]:.4f}, {old[1]:.4f} ms; bound {bound:.4f} ms")
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


def warp_grid(torch, kind, n, h, w, lo, hi, align_corners, seed):
    """A CPU grid (N, H, W, 2) float32 of a K3 check, normalised as
    F.grid_sample reads it (made in float64). "uniform": displacements
    uniform over [lo, hi + 1) per axis, floors over [lo, hi]; "integer":
    whole displacements in [lo, hi], on whole pixels up to the float32
    rounding of the grid; "outside": the frame zoomed out by 1.3 around its
    centre, so that the edge pixels sample off every edge of the image;
    "library": floors in [lo, hi] with fractions in [0.05, 0.95], away from
    the whole pixels where another rounding of the coordinate (the library
    sampler's) could take another floor; "smooth": displacements of
    smooth_flow, at most min(-lo, hi) pixels, the kind a flow network
    gives."""
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    ys = torch.arange(h, dtype=f64)[None, :, None].expand(n, h, w)
    xs = torch.arange(w, dtype=f64)[None, None, :].expand(n, h, w)
    pos = torch.stack([xs, ys], -1)
    size = torch.tensor([w, h], dtype=f64)
    shape = (n, h, w, 2)
    uniform = lambda: torch.rand(shape, generator=gen, dtype=f64)
    whole = lambda: torch.randint(lo, hi + 1, shape, generator=gen).to(f64)
    if kind == "uniform":
        coord = pos + lo + uniform() * (hi + 1 - lo)
    elif kind == "integer":
        coord = pos + whole()
    elif kind == "outside":
        centre = (size - 1) / 2
        coord = (pos - centre) * 1.3 + centre + (uniform() - 0.5) * 0.6
    elif kind == "library":
        coord = pos + whole() + 0.05 + 0.9 * uniform()
    elif kind == "smooth":
        coord = pos + smooth_flow(torch, n, h, w, min(-lo, hi), seed).to(f64)
    else:
        raise ValueError(f"no grid kind {kind!r}")
    if align_corners:
        return (2 * coord / (size - 1) - 1).float()
    return ((2 * coord + 1) / size - 1).float()


def bind_earlier_warp(lib):
    """The C signatures of a csrc/warp.cu from before the kernels took the
    grid: K3 and its fy/fx gradient on coordinate planes."""
    import ctypes
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_bounded_forward.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.warp_bounded_forward.restype = i32
    lib.warp_bounded_grad_frac.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.warp_bounded_grad_frac.restype = i32
    return lib


def earlier_warp(torch, wb, lib):
    """The bounded sampler as the tree before the fused kernels ran it:
    the plain glue of ``wb.grid_sample_bounded_ref`` around ``lib``'s K3
    (on dy0/dx0 int32 and fy/fx planes) and its fy/fx gradient, each call
    in a ``torch.cuda.device`` context as that tree's wrappers were (their
    checks left out). Returns (sampler, K3, K3's fy/fx gradient)."""
    import functools
    from torch.autograd.function import once_differentiable

    def launch(fn, *args):
        with torch.cuda.device(args[0].device):
            code = fn(*(a.data_ptr() if torch.is_tensor(a) else a
                        for a in args),
                      torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"earlier warp kernel: cudaError {code}")

    def k3(img, dy0, dx0, fy, fx, r):
        n, c, h, w = img.shape
        out = torch.empty_like(img)
        launch(lib.warp_bounded_forward, *(t.contiguous() for t in
                                           (img, dy0, dx0, fy, fx)), out,
               n, c, h, w, r)
        return out

    def k3_grad(img, dy0, dx0, fy, fx, g, r):
        n, c, h, w = img.shape
        gfy, gfx = torch.empty_like(fy), torch.empty_like(fx)
        launch(lib.warp_bounded_grad_frac, *(t.contiguous() for t in
                                             (img, dy0, dx0, fy, fx, g)),
               gfy, gfx, n, c, h, w, r)
        return gfy, gfx

    class Accumulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, img, dy0, dx0, fy, fx, r):
            ctx.save_for_backward(img, dy0, dx0, fy, fx)
            ctx.r = r
            return k3(img, dy0, dx0, fy, fx, r)

        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            img, dy0, dx0, fy, fx = ctx.saved_tensors
            gfy = gfx = gimg = None
            if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
                gfy, gfx = k3_grad(img, dy0, dx0, fy, fx, g, ctx.r)
            if ctx.needs_input_grad[0]:
                gimg = wb.warp_bounded_grad_img_ref(img, dy0, dx0, fy, fx, g,
                                                    ctx.r)
            return gimg, None, None, gfy, gfx, None

    return (functools.partial(wb.grid_sample_bounded_ref,
                              warp=Accumulate.apply), k3, k3_grad)


def warp_checks(torch, wb, case, earlier=None):
    """Hold K3, K3-grad and GridSampleBoundedFunction against the plain
    composition (autograd through wb.grid_sample_bounded_ref) and K3-grad
    against the closed form, on one case (n, c, h, w, lo, hi, kind, R,
    align_corners, padding); with ``earlier`` (earlier_warp's sampler) its
    output and grid gradient too. Returns (K3 error, K3-grad error)."""
    n, c, h, w, lo, hi, kind, r, align, padding = case
    seed = h * 1000 + w + hi + 17 * r + 3 * align
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    grid = warp_grid(torch, kind, n, h, w, lo, hi, align, seed).cuda()
    what = (f"{n}x{c}x{h}x{w} {kind} grid floors [{lo}, {hi}], R={r}, "
            f"align_corners={align}, {padding}")
    opts = (r, align, padding)
    leaves = [t.clone().requires_grad_() for t in (img, grid)]
    ref = wb.grid_sample_bounded_ref(*leaves, *opts)
    (ref * g).sum().backward()
    ref_gimg, ref_ggrid = (t.grad for t in leaves)
    err_fwd = max_err(wb.warp_sample_bounded_forward(img, grid, *opts),
                      ref.detach(), f"K3 {what}")
    ggrid = wb.warp_sample_bounded_grad_grid(img, grid, g, *opts)
    err_grad = max(
        max_err(ggrid, wb.grid_sample_bounded_grad_grid_ref(img, grid, g,
                                                            *opts),
                f"K3-grad against the closed form, {what}"),
        max_err(ggrid, ref_ggrid, f"K3-grad against autograd, {what}"))
    leaves = [t.clone().requires_grad_() for t in (img, grid)]
    out = wb.GridSampleBoundedFunction.apply(*leaves, *opts)
    (out * g).sum().backward()
    max_err(leaves[0].grad, ref_gimg, f"GridSampleBoundedFunction gimg {what}")
    max_err(leaves[1].grad, ref_ggrid,
            f"GridSampleBoundedFunction ggrid {what}")
    if earlier is not None:
        leaf = grid.clone().requires_grad_()
        out = earlier(img, leaf, *opts)
        (out * g).sum().backward()
        max_err(out.detach(), ref.detach(), f"earlier warp {what}")
        max_err(leaf.grad, ref_ggrid, f"earlier warp ggrid {what}")
    torch.cuda.synchronize()
    return err_fwd, err_grad


def warp_cases():
    """Every K3 check: (n, c, h, w, lo, hi, kind, R, align_corners,
    padding). The whole-pixel and off-the-edge ones take 2 images of 2
    channels: the kernels' instance for any C, and the batch index."""
    cases = []
    for align in (False, True):
        for padding in ("zeros", "border"):
            for h, w, lo, hi in WARP_SHAPES:
                for r in (WARP_RANGES if h < 100 else (WARP_R,)):
                    cases.append((1, 3, h, w, lo, hi, "uniform", r, align,
                                  padding))
            h, w, lo, hi = WARP_SHAPES[0]
            for kind in ("integer", "outside"):
                for r in (1, WARP_R):
                    cases.append((2, 2, h, w, lo, hi, kind, r, align,
                                  padding))
    return cases


def warp_kernel_phase(torch, wb, card, resources=None, earlier=None):
    """Hold K3 and K3-grad against their plain versions at every
    warp_cases() entry and against the library calls within range; time
    both at the RRIN main-path shape and settings, beside the plain
    version, the bound and the library call, and in turns with the earlier
    design (``earlier``: earlier_warp's (sampler, K3, K3-grad)) where
    given. Returns the per-kernel records (launches filled in later)."""
    import torch.nn.functional as F
    flops_peak, bw_peak = peaks(card)
    errs = {"fwd": 0.0, "grad": 0.0}
    cases = warp_cases()
    for case in cases:
        fwd, grad = warp_checks(torch, wb, case,
                                None if earlier is None else earlier[0])
        errs["fwd"], errs["grad"] = (max(errs["fwd"], fwd),
                                     max(errs["grad"], grad))
    print(f"[kernels] K3 and K3-grad agree with the plain composition at "
          f"{len(cases)} cases (max|diff| K3 {errs['fwd']:.3e}, K3-grad "
          f"{errs['grad']:.3e}); the Function's gradients agree with "
          f"autograd through it"
          + ("; so does the earlier warp" if earlier is not None else ""))

    # RRIN's settings at its padded frame, within range (floors in
    # [-R, R-2], so that the clamp does not act and the library calls
    # compute the same function), on random displacements and on smooth
    # ones, the kind RRIN's flow network gives
    n, c, (h, w), r = 1, 3, WARP_SHAPES[-1][:2], WARP_R
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    opts = (r, False, "zeros")
    grids = {kind: warp_grid(torch, kind, n, h, w, -r, r - 2, False, 6
                             ).cuda() for kind in ("library", "smooth")}
    calls = {}
    for kind, grid in grids.items():
        calls[kind] = {
            "fwd": lambda grid=grid: wb.warp_sample_bounded_forward(
                img, grid, *opts),
            "grad": lambda grid=grid: wb.warp_sample_bounded_grad_grid(
                img, grid, g, *opts),
            "lib_fwd": lambda grid=grid: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False),
            "lib_grad": lambda grid=grid: torch.ops.aten.grid_sampler_2d_backward(
                g, img, grid, 0, 0, False, [False, True])[1],
            "plain_fwd": lambda grid=grid: wb.grid_sample_bounded_ref(
                img, grid, *opts),
            "plain_grad": lambda grid=grid: wb.grid_sample_bounded_grad_grid_ref(
                img, grid, g, *opts)}
    # the library sampler may round a coordinate otherwise: held only on
    # the grid whose fractions keep away from whole pixels
    got = {k: calls["library"][k]() for k in ("fwd", "grad", "lib_fwd",
                                              "lib_grad")}
    lib_err = (max_err(got["fwd"], got["lib_fwd"],
                       "K3 against F.grid_sample"),
               max_err(got["grad"], got["lib_grad"],
                       "K3-grad against aten.grid_sampler_2d_backward"))
    print(f"[kernels] {n}x{c}x{h}x{w} in range, R={r}: K3 agrees with "
          f"F.grid_sample (max|diff| {lib_err[0]:.3e}), K3-grad with "
          f"aten.grid_sampler_2d_backward's grid gradient ({lib_err[1]:.3e})")
    pixels = n * h * w
    records = []
    for name, key, lib_name, ops, nbytes, replaces in [
            ("warp_sample_bounded_forward", "fwd", "F.grid_sample",
             pixels * (40 + 7 * c), pixels * (8 + 8 * c),
             "meta_interpolation_tpu/ops/warp_pallas.py:86"),
            ("warp_sample_bounded_grad_grid", "grad",
             "aten.grid_sampler_2d_backward (grid only)",
             pixels * (50 + 16 * c), pixels * (16 + 8 * c),
             "meta_interpolation_tpu/ops/warp.py:310")]:
        fn, smooth = calls["library"][key], calls["smooth"][key]
        ms, smooth_ms = time_ms(torch, fn), time_ms(torch, smooth)
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, calls["library"][f"plain_{key}"])
        library_ms = time_ms(torch, calls["library"][f"lib_{key}"])
        library_smooth_ms = time_ms(torch, calls["smooth"][f"lib_{key}"])
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        bound = max(t_ops, t_bytes)
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/warp.cu", "replaces": replaces,
            "launches": None, "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "call_ms": eager_ms,
            "smooth_ms": smooth_ms, "library_smooth_ms": library_smooth_ms,
            "shape": f"img {n}x{c}x{h}x{w}, grid {n}x{h}x{w}x2 (random "
                     f"displacements; smooth_ms: smooth ones), R={r}, zeros, "
                     f"align_corners=False",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        res = (resources or {}).get(name)
        res_txt = (f"{res['registers']} registers, {res['spill']} bytes "
                   f"spilled" if res else "registers not reported")
        print(f"[kernels] {name}: {ms:.4f} ms on random displacements, "
              f"{smooth_ms:.4f} ms on smooth ones, eager call "
              f"{eager_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound:.6f} ms by {records[-1]['bound_by']}, "
              f"{bound / ms:.3f} and {bound / smooth_ms:.3f} of the bound "
              f"reached; library {lib_name} {library_ms:.4f} and "
              f"{library_smooth_ms:.4f} ms; {res_txt})")
    if earlier is None:
        print("[kernels] K3, K3-grad: earlier design not given "
              "(--earlier-warp)")
        return records
    # the earlier K3 and its fy/fx gradient on the planes its glue makes
    # of the same grids
    for kind, grid in grids.items():
        planes = []
        wb.grid_sample_bounded_ref(img, grid, *opts,
                                   warp=lambda *a: planes.append(a) or a[0])
        planes = planes[0][:5]
        for name, this, old in [
                ("warp_sample_bounded_forward", calls[kind]["fwd"],
                 lambda: earlier[1](*planes, r)),
                ("warp_sample_bounded_grad_grid", calls[kind]["grad"],
                 lambda: earlier[2](*planes, g, r))]:
            new_ms, old_ms = in_turns(torch, (this, old))
            new_call, old_call = in_turns(torch, (this, old), call_ms)
            print(f"[kernels] {name}, {kind} grid, in turns (this, earlier, "
                  f"earlier, this): card {new_ms[0]:.4f}, {new_ms[1]:.4f} "
                  f"ms, eager call {new_call[0]:.4f}, {new_call[1]:.4f} ms; "
                  f"the earlier "
                  f"{'K3' if 'forward' in name else 'K3 fy/fx gradient'} "
                  f"alone on its planes: card {old_ms[0]:.4f}, "
                  f"{old_ms[1]:.4f} ms, eager call {old_call[0]:.4f}, "
                  f"{old_call[1]:.4f} ms")
    return records


def smooth_flow(torch, n, h, w, amplitude, seed, waves=3):
    """Seeded smooth flows (N, H, W, 2) float32 on the CPU, the kind a
    trained flow network gives: for each image and axis a sum of ``waves``
    sinusoids of at most 2 periods across the frame, with amplitudes that
    sum to at most ``amplitude`` pixels."""
    gen = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float64)[:, None] / h
    xs = torch.arange(w, dtype=torch.float64)[None, :] / w
    flow = torch.zeros(n, h, w, 2, dtype=torch.float64)
    for b in range(n):
        for c in range(2):
            for _ in range(waves):
                ky, kx, phase, amp = torch.rand(4, generator=gen,
                                                dtype=torch.float64)
                flow[b, :, :, c] += (amplitude / waves * (0.5 + 0.5 * amp)
                                     * torch.sin(2 * math.pi * (
                                         2 * ky * ys + 2 * kx * xs + phase)))
    return flow.float()


def proj_flow(torch, kind, n, h, w, span, seed):
    """A CPU flow (N, H, W, 2) of a K4 check. "uniform": in [-span, span];
    "smooth": smooth_flow of amplitude span; "integer": integer offsets in
    [-span, span] with the landings clipped to [-1, H-1] x [-1, W-1], so
    that many land exactly on the bottom and right edges and some outside;
    "one_cell": every source lands on the centre cell; "one_row": every
    source lands on row 12 (tile row 1) in columns 0-31 (the first tile),
    which fills that row's lists (sources farther than R are dropped)."""
    gen = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float32)[None, :, None].expand(n, h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, None, :].expand(n, h, w)
    if kind == "uniform":
        return (torch.rand(n, h, w, 2, generator=gen) * 2 - 1) * span
    if kind == "smooth":
        return smooth_flow(torch, n, h, w, span, seed)
    if kind == "integer":
        k = torch.randint(-span, span + 1, (n, h, w, 2), generator=gen)
        return torch.stack([(xs + k[..., 0]).clamp(-1, w - 1) - xs,
                            (ys + k[..., 1]).clamp(-1, h - 1) - ys], -1)
    if kind == "one_cell":
        return torch.stack([w // 2 - xs, h // 2 - ys], -1)
    if kind == "one_row":
        return torch.stack([xs.clamp(0, 31) - xs, 12 - ys], -1)
    raise ValueError(f"no flow kind {kind!r}")


def k4_list_lengths(torch, flow, r):
    """(mean, largest) length of the list a warp of K4 builds on ``flow``
    (N, H, W, 2) at range r: for each tile row of 32 targets, the sources
    that land on that row and in those columns within their [-R, R+1]
    window, each counted once."""
    n, h, w, _ = flow.shape
    ys = torch.arange(h, device=flow.device)[None, :, None]
    xs = torch.arange(w, device=flow.device)[None, None, :]
    x2 = xs.to(torch.float32) + flow[..., 0]
    y2 = ys.to(torch.float32) + flow[..., 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    t = torch.floor(y2).clamp(0, h - 1).long()
    l = torch.floor(x2).clamp(0, w - 1).long()
    bt, rt = (t + 1).clamp(max=h - 1), (l + 1).clamp(max=w - 1)

    def kept(v, s):
        return (v - s >= -r) & (v - s <= r + 1)

    # the distinct rows a source lands on, and the distinct tiles of its
    # columns, each with whether it is kept
    rows = [(t, kept(t, ys)), (bt, kept(bt, ys) & ~(kept(t, ys) & (bt == t)))]
    lt, rtt = l // 32, rt // 32
    cols = [(lt, kept(l, xs)), (rtt, kept(rt, xs) & ~(kept(l, xs)
                                                      & (rtt == lt)))]
    tiles_x = (w + 31) // 32
    image = torch.arange(n, device=flow.device)[:, None, None]
    counts = torch.zeros(n * h * tiles_x, dtype=torch.long,
                         device=flow.device)
    for row, row_kept in rows:
        for tile, col_kept in cols:
            hit = valid & row_kept & col_kept
            counts += torch.bincount(((image * h + row) * tiles_x + tile)[hit],
                                     minlength=counts.numel())
    return counts.float().mean().item(), int(counts.max())


def k4_in_turns(torch, fpb, earlier, flow, depth, label):
    """K4 on one flow at PROJ_R in turns with ``earlier`` (an earlier
    design's wrapper): this, earlier, earlier, this."""
    new, old = in_turns(torch, (
        lambda: fpb.flow_projection_bounded(flow, depth, PROJ_R),
        lambda: earlier(flow, depth, PROJ_R)))
    print(f"[kernels] K4 on the {label} flow, in turns (this, earlier, "
          f"earlier, this): this design {new[0]:.4f}, {new[1]:.4f} ms; "
          f"earlier design {old[0]:.4f}, {old[1]:.4f} ms")


def projection_kernel_phase(torch, fpb, card, resources=None, earlier=None):
    """Hold K4 against its plain version at every PROJ_CASES entry, with
    identical hole sets, bitwise repeatable and, where ``earlier`` (an
    earlier design's wrapper) is given, bitwise equal to it; time K4 at
    DAIN's served shape on a uniform and a smooth flow, beside the exact
    scatter, in turns with ``earlier`` where given. Returns the kernel's
    record (launches and the served frame's times filled in later)."""
    flops_peak, bw_peak = peaks(card)
    err = 0.0
    for n, h, w, r, kind, span in PROJ_CASES:
        flow = proj_flow(torch, kind, n, h, w, span, n * 1000 + h + w + r
                         ).cuda()
        gen = torch.Generator().manual_seed(h + w + r)
        depth = (torch.rand(n, h, w, 1, generator=gen) + 0.3).cuda()
        for d in (depth, None):
            what = (f"{n}x{h}x{w} R={r} {kind} flow"
                    f"{f' in [-{span}, {span}]' if span else ''}, "
                    f"{'depth' if d is not None else 'no depth'}")
            proj, cnt = fpb.flow_projection_bounded(flow, d, r)
            again = fpb.flow_projection_bounded(flow, d, r)
            rproj, rcnt = fpb.project_ref(flow, d, r)
            err = max(err, max_err(proj, rproj, f"K4 proj {what}"),
                      max_err(cnt, rcnt, f"K4 cnt {what}"))
            check(torch.equal(cnt > 0, rcnt > 0), f"K4 hole set {what}")
            check(torch.equal(proj, again[0]) and torch.equal(cnt, again[1]),
                  f"K4 {what}: two calls differ")
            same = ""
            if earlier is not None:
                eproj, ecnt = earlier(flow, d, r)
                check(torch.equal(proj, eproj) and torch.equal(cnt, ecnt),
                      f"K4 {what}: not bitwise equal to the earlier design")
                same = ", bitwise equal to the earlier design"
            torch.cuda.synchronize()
            print(f"[kernels] K4 {what}: agrees with the plain version "
                  f"(max|diff| {err:.3e}), hole sets identical, "
                  f"{int((rcnt == 0).sum())} holes, two calls bitwise "
                  f"equal{same}")
            if kind == "uniform" and r == PROJ_R and span > r and d is not None:
                exact, _ = fpb.project_ref(flow, d)
                check((exact - proj).abs().max().item() > 1e-3,
                      "K4 dropped no source past R")

    n, h, w = 1, *FULL_HW
    gen = torch.Generator().manual_seed(7)
    flow = ((torch.rand(n, h, w, 2, generator=gen) * 2 - 1) * PROJ_R).cuda()
    depth = (torch.rand(n, h, w, 1, generator=gen) + 0.3).cuda()
    smooth = smooth_flow(torch, n, h, w, PROJ_R, seed=8).cuda()
    fn = lambda: fpb.flow_projection_bounded(flow, depth, PROJ_R)
    ms, eager_ms = time_ms(torch, fn), call_ms(torch, fn)
    smooth_ms = time_ms(
        torch, lambda: fpb.flow_projection_bounded(smooth, depth, PROJ_R))
    plain_ms = time_ms(torch, lambda: fpb.project_ref(flow, depth, PROJ_R))
    exact_ms = time_ms(torch, lambda: fpb.project_ref(flow, depth))
    # the function's bytes: flow (2 planes) and depth read, proj (2) and
    # cnt written; ~30 operations a source to land and weigh it
    nbytes, ops = 4 * n * h * w * 6, 30 * n * h * w
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    rec = {"name": "flow_projection_bounded", "route": "cuda",
           "source": f"{PACKAGE}/csrc/flow_projection.cu",
           "replaces": "meta_interpolation_tpu/ops/flow_projection_pallas.py:96",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None, "call_ms": eager_ms, "smooth_ms": smooth_ms,
           "served_ms": None,
           "shape": f"flow {n}x{h}x{w}x2, depth, R={PROJ_R}",
           "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
    res = (resources or {}).get("flow_projection_bounded")
    res_txt = (f"{res['registers']} registers, {res['spill']} bytes spilled"
               if res else "registers not reported")
    lists = {label: k4_list_lengths(torch, f, PROJ_R)
             for label, f in (("uniform", flow), ("smooth", smooth))}
    print(f"[kernels] flow_projection_bounded: {ms:.4f} ms on the uniform "
          f"flow in [-{PROJ_R}, {PROJ_R}], {smooth_ms:.4f} ms on the smooth "
          f"one, eager call {eager_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}, "
          f"{rec['bound_ms'] / ms:.3f} of the bound reached; {res_txt}; "
          f"lists a warp (mean, largest): " + ", ".join(
              f"{label} {mean:.1f}, {top}" for label, (mean, top)
              in lists.items()) +
          f"; no single PyTorch call computes a scatter-average, so "
          f"library_ms is null; the exact index_add scatter takes "
          f"{exact_ms:.4f} ms)")
    if earlier is None:
        print("[kernels] flow_projection_bounded: earlier design not given "
              "(--earlier-projection)")
    else:
        k4_in_turns(torch, fpb, earlier, flow, depth, "uniform")
        k4_in_turns(torch, fpb, earlier, smooth, depth, "smooth")
    return [rec]


def reset_launches(mods):
    for mod in mods:
        mod.reset_launches()


def launch_counts(mods):
    return {name: getattr(mod, name).launches for mod in mods
            for name in KERNELS if hasattr(mod, name)}


def profile_episode(torch, run, label, ours_key):
    """One episode under torch.profiler: wall, device busy, idle share, the
    device ops (kernels, memsets, copies) and the host's cudaLaunchKernel
    calls, the share of the kernels whose names hold ``ours_key``, and the
    top kernels by device time. Returns (device ops, cudaLaunchKernel)."""
    wall, busy, top, host = device_time_by_kernel(torch, run)
    print(f"[profile] {label} host ops by self CPU time: " + "; ".join(
        f"{key} {ms:.1f} ms {count}x" for ms, count, key in host[:8]))
    if busy <= 0:
        print("[profile] torch.profiler recorded no device time")
        return None, None
    ops = sum(count for _, count, _ in top)
    launches = sum(count for _, count, key in host
                   if key == "cudaLaunchKernel")
    ours = [row for row in top if ours_key in row[2]]
    ours_ms = sum(ms for ms, _, _ in ours)
    print(f"[profile] one {label}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {ops} device "
          f"ops, {launches} cudaLaunchKernel, {ours_key} kernels "
          f"{ours_ms:.3f} ms ({ours_ms / busy:.4f} of busy)")
    for ms, count, key in top[:12] + [r for r in ours if r not in top[:12]]:
        print(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    return ops, launches


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


def main_path_phase(torch, mods, earlier_lib=None):
    """SepConv through the port's entry points on the card, the 256x448
    episode also in turns with ``earlier_lib``'s K1 and K2 where given.
    Returns the launches of the CLI run (the main path) per kernel."""
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
                    f"sepconv {FULL_HW[0]}x{FULL_HW[1]} episode", "sepconv")
    if earlier_lib is not None:
        from meta_interpolation_tpu_torch.ops import sepconv as sc
        runs = {"this": system.run_validation_iter,
                "earlier": on_library(sc, earlier_lib,
                                      system.run_validation_iter)}
        turns = {"this": [], "earlier": []}
        for which in ["this", "earlier", "earlier", "this"] * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[which](frames)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
        print(f"[main] sepconv {FULL_HW[0]}x{FULL_HW[1]} episode in turns "
              f"(this, earlier, earlier, this) x2: " + "; ".join(
                  f"{which} K1/K2 median {statistics.median(t):.4f} s (all "
                  f"{[round(x, 4) for x in t]})"
                  for which, t in turns.items()))

    # (c) a small clip on the card against the same clip on the CPU
    card_vs_cpu(cfg, "sepconv")
    return launches


def warp_call_phase(torch, mods, earlier=None, reps=10):
    """One backward_warp_rrin at RRIN's padded frame, forward (with grad)
    and the flow's gradient, on the bounded path, on the earlier warp
    (``earlier``: earlier_warp's sampler) where given, and on the exact
    path: device ops and device ms a call from torch.profiler over
    ``reps`` calls, and the eager ms of forward and backward together
    (CUDA events), in turns (bounded, earlier, exact, exact, earlier,
    bounded). The bounded path must launch K3 and K3-grad once each a
    call, the others neither."""
    from meta_interpolation_tpu_torch.ops import warp as warp_ops
    n, c, (h, w) = 1, 3, WARP_SHAPES[-1][:2]
    gen = torch.Generator().manual_seed(9)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    flow = smooth_flow(torch, n, h, w, 4.0, seed=10).cuda().requires_grad_()
    paths = {"bounded": lambda: warp_ops.backward_warp_rrin(img, flow,
                                                            WARP_R)}
    if earlier is not None:
        paths["earlier"] = with_attr(warp_ops, "grid_sample_bounded",
                                     earlier, paths["bounded"])
    paths["exact"] = lambda: warp_ops.backward_warp_rrin(img, flow, None)
    flow_grad = lambda out: torch.autograd.grad(out, flow, g)[0]
    if earlier is not None:   # the same glue and floors: the same result
        max_err(flow_grad(paths["earlier"]()), flow_grad(paths["bounded"]()),
                "warp call: the earlier path's flow gradient")
    stats = {which: {"busy": [], "ms": []} for which in paths}
    order = list(paths) + list(paths)[::-1]
    for which in order:
        fwd = paths[which]
        reset_launches(mods)
        _, fwd_busy, fwd_rows, _ = device_time_by_kernel(
            torch, lambda: [fwd() for _ in range(reps)])
        outs = [fwd() for _ in range(reps)]
        _, bwd_busy, bwd_rows, _ = device_time_by_kernel(
            torch, lambda: [flow_grad(o) for o in outs])
        launched = launch_counts(mods)
        want = {k: 0 for k in launched}
        if which == "bounded":
            want["warp_sample_bounded_forward"] = 2 * reps
            want["warp_sample_bounded_grad_grid"] = reps
        check(launched == want, f"warp call {which}: launches {launched}, "
                                f"want {want}")
        stats[which]["ops"] = (sum(k for _, k, _ in fwd_rows) / reps,
                               sum(k for _, k, _ in bwd_rows) / reps)
        stats[which]["busy"].append((fwd_busy / reps, bwd_busy / reps))
    for which in order:   # eager, with the profiler off
        stats[which]["ms"].append(
            call_ms(torch, lambda: flow_grad(paths[which]())))
    for which, st in stats.items():
        print(f"[main] rrin warp call at {n}x{c}x{h}x{w}, {which} "
              f"warp, in turns ({', '.join(order)}): forward "
              f"{st['ops'][0]:.0f} device ops, backward {st['ops'][1]:.0f}; "
              f"device ms forward " + ", ".join(f"{b[0]:.4f}" for b in
                                                st["busy"])
              + "; backward " + ", ".join(f"{b[1]:.4f}" for b in st["busy"])
              + "; eager forward and backward " + ", ".join(
                  f"{t:.4f}" for t in st["ms"]) + " ms")
    return stats


def rrin_phase(torch, mods, earlier=None):
    """RRIN through the port's entry points on the card, bounded warp, with
    the warp call and the 256x448 episode also on the exact warp and, where
    ``earlier`` (earlier_warp's sampler) is given, on the earlier warp.
    Returns the launches of the CLI run (the main path) per kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.ops import warp as warp_ops

    # (a) the CLI: the synthetic validation clips
    launches = cli_phase(torch, mods, RRIN_FLAGS, "rrin",
                         {"warp_sample_bounded_forward": K3_PER_CLIP,
                          "warp_sample_bounded_grad_grid": K3G_PER_CLIP})

    # (b) one warp call, forward and backward, on each path
    warp_call_phase(torch, mods, earlier)

    # (c) the full Vimeo frame: the bounded warp, and the exact (and the
    # earlier) warp timed in turns with it (bounded, exact, exact, bounded,
    # ...)
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
    runs = {which: system.run_validation_iter
            for which, system in systems.items()}
    if earlier is not None:
        runs["earlier"] = with_attr(warp_ops, "grid_sample_bounded", earlier,
                                    systems["bounded"].run_validation_iter)
        runs["earlier"](frames)                      # warm-up
    pairs = 4
    times = {which: [] for which in runs}
    out = {}
    reset_launches(mods)
    turns = ["bounded", "exact", "exact", "bounded"] * pairs
    if earlier is not None:
        turns += ["earlier", "bounded", "bounded", "earlier"] * pairs
    for which in turns:
        before = launch_counts(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[which] = runs[which](frames)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        if which != "bounded":
            check(launch_counts(mods) == before,
                  f"{which}-warp episode launched kernels: {before} → "
                  f"{launch_counts(mods)}")
    got = launch_counts(mods)
    n_bounded = len(times["bounded"])
    check(got["warp_sample_bounded_forward"] == K3_PER_CLIP * n_bounded
          and got["warp_sample_bounded_grad_grid"] == K3G_PER_CLIP * n_bounded,
          f"rrin {FULL_HW} launches {got} for {n_bounded} clips")
    for which, (losses, preds) in out.items():
        check(tuple(preds.shape) == (1, 3) + FULL_HW
              and bool(torch.isfinite(preds).all())
              and math.isfinite(losses["psnr"]),
              f"rrin {FULL_HW} {which} output: {losses}")
    diff = {which: (out[which][1] - out["bounded"][1]).abs().max().item()
            for which in out if which != "bounded"}
    for which in times:
        extra = (f"launches K3 {got['warp_sample_bounded_forward'] // n_bounded}"
                 f" K3-grad {got['warp_sample_bounded_grad_grid'] // n_bounded}"
                 f" per clip, peak memory {peak_gib:.2f} GiB"
                 if which == "bounded" else
                 f"max|pred diff| against the bounded {diff[which]:.3e}")
        print(f"[main] rrin {FULL_HW[0]}x{FULL_HW[1]} episode, {which} warp"
              f"{'' if which == 'exact' else f' R={WARP_R}'}: median "
              f"{statistics.median(times[which]):.4f} s over "
              f"{len(times[which])} in turns (all "
              f"{[round(t, 4) for t in times[which]]}), PSNR "
              f"{out[which][0]['psnr']:.3f}, {extra}")
    for which, run in runs.items():
        profile_episode(torch, lambda: run(frames),
                        f"rrin {FULL_HW[0]}x{FULL_HW[1]} episode, {which} "
                        f"warp", "warp_sample" if which == "bounded" else
                        "grid_sampler" if which == "exact" else "warp_bounded")
    clip = systems["bounded"]._frames(frames)[0]
    q0, _, q1 = RRIN_QUERY
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        systems["bounded"].model(clip[q0][None], clip[q1][None])
    print(f"[main] rrin forward at {FULL_HW[0]}x{FULL_HW[1]}: "
          f"{counter.get_total_flops() / 1e9:.3f} GFLOP "
          f"(torch.utils.flop_counter)")

    # (d) a small clip on the card against the same clip on the CPU
    card_vs_cpu(get_args(RRIN_FLAGS), "rrin")
    return launches


def dain_weights(torch):
    """Random DAIN weights from DAIN_SEED with the depth head tamed, also
    written to DAIN_PTH for the CLI's --pretrained_model."""
    from meta_interpolation_tpu_torch.models.dain.model import (
        DAIN, tame_depth_head_)
    model = tame_depth_head_(DAIN(torch.Generator().manual_seed(DAIN_SEED)))
    os.makedirs(os.path.dirname(DAIN_PTH), exist_ok=True)
    torch.save(model.state_dict(), DAIN_PTH)
    return model


def dain_served_phase(torch, mods, model, earlier_k4=None):
    """One frame pair at 256x448 through DAIN.forward with proj_range and
    hole filling, timed in turns with the exact projection; K4 timed on the
    two flows the frame projects, in turns with ``earlier_k4`` (an earlier
    design's wrapper) where given. Returns the launches of the bounded runs
    per kernel and K4's times on the frame's flows."""
    from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    frames = SyntheticSeptuplet(model="dain", mode="val", size=FULL_HW)[0][0]
    f0, f1 = (torch.tensor(frames[i]).permute(2, 0, 1)[None].contiguous()
              .cuda() for i in DAIN_QUERY)
    model = model.cuda()
    runs = {"bounded": lambda: model(f0, f1, proj_range=PROJ_R,
                                     fill_holes=True),
            "exact": lambda: model(f0, f1, fill_holes=True)}
    with torch.no_grad():
        for run in runs.values():
            run()                                   # warm-up
        times = {"bounded": [], "exact": []}
        out = {"bounded": [], "exact": []}
        reset_launches(mods)
        for which in ["bounded", "exact", "exact", "bounded"] * 3:
            want = launch_counts(mods)
            if which == "bounded":
                want["flow_projection_bounded"] += K4_PER_FRAME
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[which].append(runs[which]())
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            check(launch_counts(mods) == want,
                  f"dain {which} frame launches {launch_counts(mods)}, "
                  f"want {want}")
        launches = launch_counts(mods)
        n_frames = len(times["bounded"])
        check(launches["flow_projection_bounded"] == K4_PER_FRAME * n_frames,
              f"dain served launches {launches} for {n_frames} frames")
        for which, preds in out.items():
            for pred in preds:
                check(tuple(pred.shape) == (1, 3) + FULL_HW
                      and bool(torch.isfinite(pred).all()),
                      f"dain served {which} output {tuple(pred.shape)}")
        # bounded against exact, beside exact against exact: the forward
        # itself is not bitwise repeatable on the card
        diff = max((b - e).abs().max().item()
                   for b, e in zip(out["bounded"], out["exact"]))
        noise = max((e - out["exact"][0]).abs().max().item()
                    for e in out["exact"])
        flow_max = max(f.abs().max().item() for f in model.flows(f0, f1))
        # the offsets (projected flows) of one frame on each path, and K4's
        # offsets against the exact scatter's on the very same inputs
        calls, offsets = [], []
        real = dain_mod.flow_projection

        def spy(*args, **kwargs):
            calls.append((args, kwargs))
            offsets.append(real(*args, **kwargs))
            return offsets[-1]

        dain_mod.flow_projection = spy
        try:
            runs["bounded"]()
            runs["exact"]()
        finally:
            dain_mod.flow_projection = real
        same_inputs = max(
            max_err(off, real(*args, **{**kwargs, "proj_range": None}),
                    "dain served: K4 offsets against the exact scatter's")
            for (args, kwargs), off in zip(calls[:2], offsets[:2]))
        off_diff = max((a - b).abs().max().item()
                       for a, b in zip(offsets[:2], offsets[2:]))
        flow_diff = max((a[0][0] - b[0][0]).abs().max().item()
                        for a, b in zip(calls[:2], calls[2:]))
        # K4 alone on the two (flow, depth) pairs the bounded frame projects
        served = [(args[0].contiguous(), args[1].contiguous())
                  for args, _ in calls[:2]]
        served_ms = [time_ms(torch, lambda f=f, d=d:
                             fpb.flow_projection_bounded(f, d, PROJ_R))
                     for f, d in served]
        served_lists = [k4_list_lengths(torch, f, PROJ_R) for f, _ in served]
        torch.cuda.reset_peak_memory_stats()
        runs["bounded"]()
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with FlopCounterMode(display=False) as counter:
            runs["bounded"]()
    for which in times:
        print(f"[main] dain served {FULL_HW[0]}x{FULL_HW[1]} frame, "
              f"{which} projection"
              f"{f' R={PROJ_R}' if which == 'bounded' else ''}: median "
              f"{statistics.median(times[which]):.4f} s/frame over "
              f"{len(times[which])} in turns (all "
              f"{[round(t, 4) for t in times[which]]})")
    print(f"[main] dain served: K4 launches {launches} over {n_frames} "
          f"bounded frames ({K4_PER_FRAME} a frame, none on the exact "
          f"ones); bounded vs exact max|pred diff| {diff:.3e} (exact vs "
          f"exact {noise:.3e}), max|offset diff| {off_diff:.3e} on flows "
          f"{flow_diff:.3e} apart and {same_inputs:.3e} on the same flows; "
          f"flows' "
          f"max|value| {flow_max:.3f} px against R = {PROJ_R}; peak memory "
          f"{peak_gib:.2f} GiB; forward {counter.get_total_flops() / 1e9:.3f}"
          f" GFLOP (torch.utils.flop_counter)")
    print(f"[main] dain served: K4 on the frame's own two flows "
          f"{served_ms[0]:.4f}, {served_ms[1]:.4f} ms (lists a warp, mean "
          f"and largest: " + "; ".join(f"{mean:.1f}, {top}" for mean, top
                                       in served_lists) + ")")
    if earlier_k4 is not None:
        for (f, d), which in zip(served, ("first", "second")):
            k4_in_turns(torch, fpb, earlier_k4, f, d, f"served frame's {which}")
    with torch.no_grad():
        profile_episode(torch, runs["bounded"],
                        f"dain served {FULL_HW[0]}x{FULL_HW[1]} frame",
                        "flow_projection")
    return launches, served_ms


def flip_mask(torch, values, delta):
    """(H, W) bool: the pixels within FLIP_REACH of where a projection value
    within delta of an integer acts. values: (flow, offsets) pairs of the
    projections, (N, H, W, 2) each, (fx, fy) last. A flow acts at the cell
    its source lands on, an offset at its own pixel."""
    import torch.nn.functional as F
    h, w = SMALL_HW
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    hits = torch.zeros(1, 1, h, w)
    for flow, off in values:
        check(tuple(flow.shape[1:3]) == SMALL_HW,
              f"projection at {tuple(flow.shape)}: padded past {SMALL_HW}")
        for v, ty, tx in ((flow, ys + flow[..., 1], xs + flow[..., 0]),
                          (off, ys.expand(off.shape[:3]),
                           xs.expand(off.shape[:3]))):
            near = ((v - v.round()).abs() < delta).any(-1)   # (N, H, W)
            hits[0, 0, ty[near].round().clamp(0, h - 1).long(),
                 tx[near].round().clamp(0, w - 1).long()] = 1.0
    return F.max_pool2d(hits, 2 * FLIP_REACH + 1, stride=1,
                        padding=FLIP_REACH)[0, 0] > 0


def dain_card_vs_cpu(torch, cfg, state):
    """The first small synthetic clip on the card and on the CPU. A pixel
    may exceed the limit only inside the flip mask: within FLIP_REACH of
    where a projection input or output value (a flow the projection or the
    filter interpolation floors) within delta of an integer on the CPU run
    acts, since there the two devices may take other floors. delta is the
    larger of NEAR_INT and the devices' largest flow difference in the
    first forward, where both still hold the same weights. The PSNR of the
    pixels outside the mask agrees to PSNR_TOL_DB, always."""
    from meta_interpolation_tpu_torch.core.metrics import (
        psnr_from_quantized, quantize)
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    clip = SyntheticSeptuplet(model="dain", mode="val",
                              size=SMALL_HW)[0][0][None]
    seen = {"cuda": [], "cpu": []}
    real = dain_mod.flow_projection
    dev = None

    def spy(flow, *args, **kwargs):
        off = real(flow, *args, **kwargs)
        seen[dev].append((flow.detach().cpu(), off.detach().cpu()))
        return off

    preds, psnr = {}, {}
    dain_mod.flow_projection = spy
    try:
        for dev in ("cuda", "cpu"):
            system = SceneAdaptiveInterpolation(cfg, device=dev)
            system.load_net(state)
            losses, pred = system.run_validation_iter(clip)
            preds[dev], psnr[dev] = pred.cpu(), losses["psnr"]
    finally:
        dain_mod.flow_projection = real
    # the first forward's two projections: same weights on both devices
    d_flow = max((a[0] - b[0]).abs().max().item()
                 for a, b in zip(seen["cuda"][:2], seen["cpu"][:2]))
    delta = max(NEAR_INT, d_flow)
    near = sum(int(((v - v.round()).abs() < delta).sum())
               for pair in seen["cpu"] for v in pair)
    n_values = sum(v.numel() for pair in seen["cpu"] for v in pair)
    mask = flip_mask(torch, seen["cpu"], delta)
    keep = ~mask
    diff = (preds["cuda"] - preds["cpu"]).abs().amax(1)[0]      # (H, W)
    lim = TOL_REL * preds["cpu"].abs().max().item() + TOL_ABS
    outside = int(((diff > lim) & keep).sum())
    inside = int(((diff > lim) & mask).sum())
    share_1e4 = float((diff > 1e-4).float().mean())
    # the repo's PSNR of the query frame over the pixels outside the mask
    target = torch.tensor(clip[0, cfg.target_idxs[1]]).permute(2, 0, 1)
    kept_psnr = {dev: psnr_from_quantized(quantize(p[0][:, keep]),
                                          quantize(target[:, keep])).item()
                 for dev, p in preds.items()}
    dpsnr_kept = abs(kept_psnr["cuda"] - kept_psnr["cpu"])
    msg = (f"dain {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: max|pred "
           f"diff| {diff.max().item():.3e}, share of pixels beyond 1e-4 "
           f"{share_1e4:.5f}, PSNR diff {abs(psnr['cuda'] - psnr['cpu']):.3e}"
           f" dB; first-forward max|flow diff| {d_flow:.3e}; {near} of "
           f"{n_values} projection values within {delta:.3e} of an integer, "
           f"their flip mask {int(mask.sum())} of {mask.numel()} pixels; "
           f"beyond {lim:.3e} (1e-4 max|pred| + 1e-5): {outside} pixels "
           f"outside the mask (must be 0), {inside} inside; PSNR outside "
           f"the mask {dpsnr_kept:.3e} dB apart (limit {PSNR_TOL_DB})")
    check(int(keep.sum()) > 0 and outside == 0
          and dpsnr_kept <= PSNR_TOL_DB, msg)
    print(f"[main] {msg}")

def dain_served_card_vs_cpu(torch, state):
    """One served forward (proj_range=PROJ_R, hole filling) of the first
    small synthetic clip's query pair on the card, then on the CPU with the
    same weights, handed the card's PWC flows, log depths and projected
    offsets (spies on DAIN.flows, depthNet and flow_projection), so that no
    floor can flip: every pixel must lie within 1e-4·max|pred| + 1e-5, with
    no mask."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    frames = SyntheticSeptuplet(model="dain", mode="val", size=SMALL_HW)[0][0]
    pair = [torch.tensor(frames[i]).permute(2, 0, 1)[None].contiguous()
            for i in DAIN_QUERY]
    seen = {"flows": [], "depth": [], "offsets": []}
    real = dain_mod.flow_projection
    preds = {}
    for dev in ("cuda", "cpu"):
        model = dain_mod.DAIN(torch.Generator().manual_seed(DAIN_SEED))
        model.load_state_dict(state)
        inputs = pair
        if dev == "cuda":
            model, inputs = model.cuda(), [f.cuda() for f in pair]
            real_flows = model.flows

            def flows(x0, x2):
                out = real_flows(x0, x2)
                seen["flows"].append(tuple(f.cpu() for f in out))
                return out

            def depth(module, args, out):
                seen["depth"].append(out.cpu())

            def project(*args, **kwargs):
                out = real(*args, **kwargs)
                seen["offsets"].append(out.cpu())
                return out
        else:
            check(len(seen["flows"]) == 1 and len(seen["depth"]) == 1
                  and len(seen["offsets"]) == 2,
                  f"dain served: spies saw {[len(v) for v in seen.values()]}")
            offsets = iter(seen["offsets"])
            flows = lambda x0, x2: seen["flows"][0]
            depth = lambda module, args, out: seen["depth"][0]
            project = lambda *args, **kwargs: next(offsets)
        model.flows = flows
        hook = model.depthNet.register_forward_hook(depth)
        dain_mod.flow_projection = project
        try:
            with torch.no_grad():
                preds[dev] = model(*inputs, proj_range=PROJ_R,
                                   fill_holes=True).cpu()
        finally:
            dain_mod.flow_projection = real
            hook.remove()
    diff = (preds["cuda"] - preds["cpu"]).abs()
    lim = TOL_REL * preds["cpu"].abs().max().item() + TOL_ABS
    beyond = int((diff > lim).sum())
    msg = (f"dain served {SMALL_HW[0]}x{SMALL_HW[1]} frame, card vs CPU on "
           f"the card's flows, log depths and offsets: max|pred diff| "
           f"{diff.max().item():.3e}, {beyond} of {diff.numel()} values "
           f"beyond {lim:.3e} (1e-4 max|pred| + 1e-5; must be 0, no mask)")
    check(bool(torch.isfinite(preds["cuda"]).all()) and beyond == 0, msg)
    print(f"[main] {msg}")


def dain_phase(torch, mods, earlier_k4=None):
    """DAIN through the port's entry points on the card: served with the
    bounded projection, then the CLI and an episode with the exact one.
    Returns the launches of the served runs (K4's main path) per kernel and
    K4's times on the served frame's flows."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    model = dain_weights(torch)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    launches, served_ms = dain_served_phase(torch, mods, model, earlier_k4)
    del model

    # the CLI: the meta system projects exactly, as the JAX one does
    cli_phase(torch, mods, DAIN_FLAGS, "dain", {})

    # one 256x448 episode
    cfg = get_args(DAIN_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    system.load_net(state)
    frames = SyntheticSeptuplet(model="dain", mode="val",
                                size=FULL_HW)[0][0][None]
    torch.cuda.reset_peak_memory_stats()
    system.run_validation_iter(frames)             # warm-up
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reps = 3
    reset_launches(mods)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, preds = system.run_validation_iter(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = launch_counts(mods)
    check(not any(got.values()), f"dain episode launched kernels: {got}")
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"dain {FULL_HW} output: "
                                              f"{losses}")
    print(f"[main] dain {FULL_HW[0]}x{FULL_HW[1]} episode, exact projection: "
          f"median {statistics.median(times):.4f} s over {reps} (all "
          f"{[round(t, 4) for t in times]}), PSNR {losses['psnr']:.3f}, no "
          f"kernel launched, peak memory {peak_gib:.2f} GiB")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"dain {FULL_HW[0]}x{FULL_HW[1]} episode", "conv")
    del system

    # a small clip on the card against the same clip on the CPU, and a
    # served frame on the CPU from the card's flows, depths and offsets
    dain_card_vs_cpu(torch, cfg, state)
    dain_served_card_vs_cpu(torch, state)
    return launches, served_ms


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier-sepconv", metavar="PATH",
                        help="an earlier csrc/sepconv.cu to time K1/K2 "
                             "against, in turns")
    parser.add_argument("--earlier-projection", metavar="PATH",
                        help="an earlier csrc/flow_projection.cu to hold K4 "
                             "to bit for bit and time it against, in turns")
    parser.add_argument("--earlier-warp", metavar="PATH",
                        help="an earlier csrc/warp.cu (K3 and its fy/fx "
                             "gradient on coordinate planes) to run in the "
                             "plain glue, hold to the plain composition and "
                             "time against K3, K3-grad, the warp call and "
                             "the RRIN episode, in turns")
    return parser.parse_args(argv)


def main():
    args = parse_args()
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
    from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb

    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # earlier designs by source: (C signature binder, path, ptxas names)
    earlier = {source: (bind, path, entries)
               for source, bind, path, entries in [
                   ("sepconv", sc._bind, args.earlier_sepconv,
                    SEPCONV_KERNELS),
                   ("flow_projection", fpb._bind, args.earlier_projection,
                    PROJECTION_KERNELS),
                   ("warp", bind_earlier_warp, args.earlier_warp,
                    EARLIER_WARP_KERNELS)] if path}
    builds = {source: start_build(path, "earlier", source)
              for source, (_, path, _) in earlier.items()}
    report = _build.build()
    print(f"[build] {len(report)} source(s) in {time.perf_counter() - t0:.1f}"
          f" s")
    for name, rec in report.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for line in str(rec["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}")
    resources = sepconv_resources(report["sepconv"]["log"], "sepconv.cu")
    k3_resources = kernel_resources(report["warp"]["log"], "warp.cu",
                                    WARP_KERNELS)
    k4_resources = kernel_resources(report["flow_projection"]["log"],
                                    "flow_projection.cu", PROJECTION_KERNELS)
    libs = {source: finish_build(bind, *builds[source], f"earlier {path}",
                                 entries)
            for source, (bind, path, entries) in earlier.items()}
    earlier_k4 = (on_library(fpb, libs["flow_projection"],
                             fpb.flow_projection_bounded)
                  if "flow_projection" in libs else None)
    earlier_k3 = (earlier_warp(torch, wb, libs["warp"]) if "warp" in libs
                  else None)

    records = (kernel_phase(torch, sc, card, resources, libs.get("sepconv"))
               + warp_kernel_phase(torch, wb, card, k3_resources, earlier_k3)
               + projection_kernel_phase(torch, fpb, card, k4_resources,
                                         earlier_k4))
    mods = (sc, wb, fpb)
    sepconv_launches = main_path_phase(torch, mods, libs.get("sepconv"))
    rrin_launches = rrin_phase(torch, mods,
                               earlier_k3[0] if earlier_k3 else None)
    dain_launches, served_ms = dain_phase(torch, mods, earlier_k4)
    records[-1]["served_ms"] = served_ms
    # each kernel's launches on the main path that runs it
    launches = {**{k: sepconv_launches[k] for k in KERNELS[:2]},
                **{k: rrin_launches[k] for k in KERNELS[2:4]},
                **{k: dain_launches[k] for k in KERNELS[4:]}}
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
