"""chip_smoke.py's reading of the kernels' build report, on the CPU.

chip_smoke.py runs only on a CUDA card; what it computes from the text
nvcc prints (registers, spills) is held here on a report of the form
``nvcc -Xptxas -v`` gives.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's PyTorch work (the tier-1 run
    puts six test processes on the machine's cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FWD = "_ZN12_GLOBAL__N_118sepconv_fwd_kernelEPKfS1_S1_Pfiii"
GRAD = "_ZN12_GLOBAL__N_127sepconv_grad_kernels_kernelEPKfS1_S1_S1_PfS2_iii"


def _log(grad_spill=0):
    return f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{GRAD}' for 'sm_90a'
ptxas info    : Function properties for {GRAD}
    8 bytes stack frame, {grad_spill} bytes spill stores, {grad_spill} bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 244.167 ms
ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 159 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_entry_function():
    report = chip_smoke.ptxas_report(_log(grad_spill=4))
    assert report == {GRAD: {"stack": 8, "spill": 8, "registers": 168},
                      FWD: {"stack": 0, "spill": 0, "registers": 159}}


def test_sepconv_resources_names_the_wrappers():
    res = chip_smoke.sepconv_resources(_log(), "sepconv.cu")
    assert res["sepconv_forward"]["registers"] == 159
    assert res["sepconv_grad_kernels"]["registers"] == 168


def test_sepconv_resources_fail_on_a_spill_unless_told_not_to():
    with pytest.raises(AssertionError, match="spills 8 bytes"):
        chip_smoke.sepconv_resources(_log(grad_spill=4), "sepconv.cu")
    res = chip_smoke.sepconv_resources(_log(grad_spill=4), "earlier",
                                       no_spill=False)
    assert res["sepconv_grad_kernels"]["spill"] == 8


def test_sepconv_resources_of_a_reused_library_are_none():
    assert chip_smoke.sepconv_resources("reused libsepconv-0123.so",
                                        "sepconv.cu") is None


K4 = "_ZN51_GLOBAL__N__f20a55e7_18_flow_projection_cu_5571f3b622flow_projection_kernelEPKfS1_PfS2_iiii"


@pytest.mark.parametrize("spill", [0, 12])
def test_kernel_resources_read_k4_and_fail_on_its_spill(spill):
    log = f"""ptxas info    : Compiling entry function '{K4}' for 'sm_90a'
ptxas info    : Function properties for {K4}
    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
"""
    entries = chip_smoke.PROJECTION_KERNELS
    if spill:
        with pytest.raises(AssertionError, match="spills 24 bytes"):
            chip_smoke.kernel_resources(log, "flow_projection.cu", entries)
    res = chip_smoke.kernel_resources(log, "flow_projection.cu", entries,
                                      no_spill=False)
    assert res["flow_projection_bounded"] == {"stack": 0, "spill": 2 * spill,
                                              "registers": 48}


@pytest.mark.parametrize("argv, want", [
    ([], None), (["--earlier-projection", "build/k4.cu"], "build/k4.cu")])
def test_parse_args_takes_an_earlier_projection(argv, want):
    args = chip_smoke.parse_args(argv)
    assert args.earlier_projection == want
    assert args.earlier_sepconv is None


def test_smooth_flow_is_seeded_bounded_and_smooth():
    """Flows of a few sinusoids: the same for the same seed, another for
    another seed, |value| within the amplitude, and neighbours within the
    steepest slope a sum of at most 2 periods a frame allows."""
    import torch
    n, h, w, amp = 2, 40, 56, 8.0
    flow = chip_smoke.smooth_flow(torch, n, h, w, amp, seed=3)
    assert flow.shape == (n, h, w, 2) and flow.dtype == torch.float32
    assert torch.equal(flow, chip_smoke.smooth_flow(torch, n, h, w, amp, 3))
    assert not torch.equal(flow, chip_smoke.smooth_flow(torch, n, h, w, amp,
                                                        4))
    assert float(flow.abs().max()) <= amp
    assert float(flow.abs().max()) > amp / 4
    slope = 2 * 3.1416 * 2 * amp * (1 / h + 1 / w)
    assert float((flow[:, 1:] - flow[:, :-1]).abs().max()) <= slope
    assert float((flow[:, :, 1:] - flow[:, :, :-1]).abs().max()) <= slope


@pytest.mark.parametrize("kind", ["uniform", "smooth", "integer", "one_cell",
                                  "one_row"])
def test_proj_flow_makes_each_kind(kind):
    """Each K4 check flow: seeded; integer flows land on whole pixels, many
    on the bottom and right edges; one_cell lands every source on the
    centre; one_row every source on row 12, columns 0-31."""
    import torch
    n, h, w, span = 2, 37, 53, 9
    flow = chip_smoke.proj_flow(torch, kind, n, h, w, span, seed=5)
    assert flow.shape == (n, h, w, 2) and flow.dtype == torch.float32
    assert torch.equal(flow, chip_smoke.proj_flow(torch, kind, n, h, w, span,
                                                  5))
    y2 = torch.arange(h)[None, :, None] + flow[..., 1]
    x2 = torch.arange(w)[None, None, :] + flow[..., 0]
    if kind in ("uniform", "smooth"):
        assert float(flow.abs().max()) <= span
    elif kind == "integer":
        assert torch.equal(y2, y2.round()) and torch.equal(x2, x2.round())
        assert int((y2 == h - 1).sum()) > w and int((x2 == w - 1).sum()) > h
        assert float(y2.min()) == -1 and float(x2.min()) == -1
    elif kind == "one_cell":
        assert bool((y2 == h // 2).all() and (x2 == w // 2).all())
    else:
        assert bool((y2 == 12).all() and (x2 <= 31).all())


@pytest.mark.parametrize("argv, want", [
    ([], None), (["--earlier-warp", "build/warp.cu"], "build/warp.cu")])
def test_parse_args_takes_an_earlier_warp(argv, want):
    args = chip_smoke.parse_args(argv)
    assert args.earlier_warp == want
    assert args.earlier_projection is None and args.earlier_sepconv is None


@pytest.mark.parametrize("symbols, api", [
    # today's C interface: the bf16 entry points, before or after the
    # gather route had its own
    (("warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
      "warp_sample_bounded_grad_grid_backward",
      "warp_sample_bounded_forward_bf16",
      "warp_sample_bounded_grad_grid_bf16"), "grid"),
    # a source from before the kernels took the grid
    (("warp_bounded_forward", "warp_bounded_grad_frac"), "planes")])
def test_earlier_warp_binding_is_chosen_by_symbol(symbols, api):
    """--earlier-warp binds a library with the bf16 entry point as the
    checkout's (ops/warp_bounded._bind), else with the plane interface."""
    from types import SimpleNamespace
    lib = SimpleNamespace(**{name: SimpleNamespace() for name in symbols})
    got, bound = chip_smoke.bind_earlier_warp(lib)
    assert (got, bound) == (api, lib)
    if api == "grid":
        assert len(lib.warp_sample_bounded_forward.argtypes) == 11
        assert (lib.warp_sample_bounded_forward_bf16.argtypes
                == lib.warp_sample_bounded_forward.argtypes)
        assert len(lib.warp_sample_bounded_grad_grid_bf16.argtypes) == 12
    else:
        assert len(lib.warp_bounded_forward.argtypes) == 12
        assert len(lib.warp_bounded_grad_frac.argtypes) == 14


@pytest.mark.parametrize("text, want", [
    ('extern "C" int warp_sample_bounded_forward_bf16(', "gather"),
    ('extern "C" int warp_bounded_forward(', "planes")])
def test_earlier_warp_kernels_follow_the_source(tmp_path, text, want):
    """The ptxas names an earlier warp.cu's report is read for: the
    gather design's kernels, or the plane interface's."""
    path = tmp_path / "warp.cu"
    path.write_text(text)
    assert chip_smoke.earlier_warp_kernels(str(path)) == (
        chip_smoke.GATHER_WARP_KERNELS if want == "gather"
        else chip_smoke.EARLIER_WARP_KERNELS)


def test_kernel_resources_read_static_shared_memory():
    """ptxas names static shared memory only where a kernel has some."""
    log = f"""ptxas info    : Compiling entry function '{FWD}' for 'sm_90a'
ptxas info    : Function properties for {FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 360 bytes cmem[0]
ptxas info    : Compiling entry function '{GRAD}' for 'sm_90a'
ptxas info    : Function properties for {GRAD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 0 barriers, 360 bytes cmem[0]
"""
    res = chip_smoke.sepconv_resources(log, "sepconv.cu")
    assert res["sepconv_forward"] == {"registers": 40, "spill": 0,
                                      "stack": 0, "smem": 4096}
    assert res["sepconv_grad_kernels"] == {"registers": 56, "spill": 0,
                                           "stack": 0}


def test_kernel_resources_take_the_most_over_template_instances():
    """K3 is built for C = 3 and for any C: two entries, one wrapper."""
    log = "".join(
        f"""ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122warp_sample_fwd_kernelILi{k}EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for x
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers
""" for k, regs in ((3, 40), (0, 36)))
    res = chip_smoke.kernel_resources(
        log, "warp.cu", {"warp_sample_bounded_forward":
                         "warp_sample_fwd_kernel"})
    assert res == {"warp_sample_bounded_forward": {"stack": 0, "spill": 0,
                                                   "registers": 40}}


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "integer", "outside", "library",
                                  "smooth"])
def test_warp_grid_makes_each_kind(kind, align_corners):
    """Each K3 check grid, unnormalised as F.grid_sample reads it: seeded;
    uniform floors over [lo, hi]; integer ones on whole pixels; outside
    ones off every edge of the image; library ones with fractions away
    from whole pixels; smooth ones within min(-lo, hi) pixels."""
    import torch
    n, h, w, lo, hi = 2, 37, 53, -8, 6
    grid = chip_smoke.warp_grid(torch, kind, n, h, w, lo, hi, align_corners,
                                seed=3)
    assert grid.shape == (n, h, w, 2) and grid.dtype == torch.float32
    assert torch.equal(grid, chip_smoke.warp_grid(
        torch, kind, n, h, w, lo, hi, align_corners, 3))
    size = torch.tensor([w, h], dtype=torch.float64)
    g = grid.double()
    coord = ((g + 1) / 2 * (size - 1) if align_corners
             else ((g + 1) * size - 1) / 2)
    pos = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(h),
                                     indexing="xy"), -1).double()
    disp, frac = coord - pos, coord - coord.floor()
    if kind in ("uniform", "library"):
        assert disp.floor().min() == lo and disp.floor().max() == hi
    if kind == "integer":
        assert (coord - coord.round()).abs().max() < 1e-4
        assert disp.round().min() == lo and disp.round().max() == hi
    elif kind == "outside":
        for axis, extent in ((0, w), (1, h)):
            assert coord[..., axis].min() < -1
            assert coord[..., axis].max() > extent
    elif kind == "library":
        assert frac.min() > 0.05 - 1e-4 and frac.max() < 0.95 + 1e-4
    elif kind == "smooth":
        assert disp.abs().max() <= min(-lo, hi) + 1e-4


def test_warp_cases_cover_every_setting():
    """Both paddings and both align_corners; R = 1, 3 and 8 on the ragged
    shapes; every displacement kind, smooth ones (K3-grad²'s check of
    random and smooth displacements) at the main-path shape in every
    setting; C = 3 and another C, N = 1 and 2; the main-path shape at
    R = 8."""
    cases = chip_smoke.warp_cases()
    assert {(c[8], c[9]) for c in cases} == {
        (a, p) for a in (False, True) for p in ("zeros", "border")}
    assert {c[7] for c in cases} == {1, 3, 8}
    assert {c[6] for c in cases} == {"uniform", "integer", "outside",
                                     "smooth"}
    assert {(c[8], c[9]) for c in cases if c[6] == "smooth"
            and c[2:4] == (256, 512)} == {(c[8], c[9]) for c in cases}
    assert {c[:2] for c in cases} == {(1, 3), (2, 2)}
    assert (1, 3, 256, 512, -8, 7, "uniform", 8, False, "zeros") in cases
    assert any(c[5] > c[7] for c in cases)   # displacements past R


def test_training_launch_counts_are_derived_from_the_preset():
    """run_sepconv.sh: 3 tasks of 3 inner steps, 2 support pairs, 2
    sepconvs a forward. First order, 14 K1 and 14 K2 a task; second order,
    12n + 2 of each a task (one K2 per double backward)."""
    assert chip_smoke.K1_PER_TRAIN_ITER == chip_smoke.K2_PER_TRAIN_ITER == 42
    assert (chip_smoke.K1_PER_TASK_SECOND_ORDER
            == chip_smoke.K2_PER_TASK_SECOND_ORDER == 12 * 3 + 2)
    assert "--second_order" not in chip_smoke.TRAIN_FLAGS
    assert chip_smoke.TRAIN_FLAGS[chip_smoke.TRAIN_FLAGS.index(
        "--batch_size") + 1] == str(chip_smoke.TASKS)


def test_count_calls_records_the_launches_of_each_call():
    from types import SimpleNamespace

    import torch

    def sepconv_forward():
        sepconv_forward.launches += 1
    sepconv_forward.launches = 0
    mod = SimpleNamespace(sepconv_forward=sepconv_forward)
    card = SimpleNamespace(cuda=SimpleNamespace(synchronize=lambda: None))

    class System:
        meta_params = {"net": {"moduleConv1.0.weight": torch.ones(2)}}

        def run_train_iter(self, frames, epoch):
            sepconv_forward()
            sepconv_forward()
            return {"loss": 1.0}, frames

    log = []
    wrapped = chip_smoke.count_calls(card, (mod,), System, "run_train_iter",
                                     log)
    out = wrapped(System(), "frames", 3)
    assert out == ({"loss": 1.0}, "frames")
    epoch, launches, w0, result = log[0]
    assert (epoch, launches["sepconv_forward"], result) == (3, 2, out)
    assert torch.equal(w0, torch.ones(2))


def test_warp_model_launch_counts_are_derived_from_the_presets():
    """run_superslomo.sh and run_voxelflow.sh: 1 evaluation step over 2
    support pairs, then the query; 6 and 2 warps a forward, each with a
    K3-grad in a support backward."""
    assert (chip_smoke.K3_PER_CLIP_SSM, chip_smoke.K3G_PER_CLIP_SSM) == (18,
                                                                          12)
    assert (chip_smoke.K3_PER_CLIP_VF, chip_smoke.K3G_PER_CLIP_VF) == (6, 4)
    for flags, loss in ((chip_smoke.SSM_FLAGS, "1*Super"),
                        (chip_smoke.VF_FLAGS, "1*MSE")):
        assert loss in flags and "--metasgd" in flags
        assert flags[flags.index("--optimizer") + 1] == "Adam"
        assert flags[flags.index("--fast_warp_range") + 1] == "8"
        for steps in ("--number_of_training_steps_per_iter",
                      "--number_of_evaluation_steps_per_iter"):
            assert flags[flags.index(steps) + 1] == "1"


def test_warp_cases_hold_voxelflows_call():
    """K3 is checked at VoxelFlow's main-path call: one 256x448 frame,
    border padding, align_corners=True, R = 8."""
    case = chip_smoke.VF_WARP_CASE
    assert case in chip_smoke.warp_cases()
    assert case[:4] == (1, 3, 256, 448) and case[7:] == (8, True, "border")


@pytest.fixture
def counted_warp(monkeypatch):
    """The K3 and K3-grad wrappers counting on the CPU (where they run
    their plain versions and count nothing)."""
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    ref = wb.grid_sample_bounded_ref
    ref_grad = wb.grid_sample_bounded_grad_grid_ref

    def fwd(img, grid, r, align_corners=False, padding_mode="zeros",
            row0=0):
        fwd.launches += 1
        return ref(img, grid, r, align_corners, padding_mode, row0=row0)

    def grad(img, grid, g, r, align_corners=False, padding_mode="zeros",
             row0=0):
        grad.launches += 1
        return ref_grad(img, grid, g, r, align_corners, padding_mode, row0)
    fwd.launches = grad.launches = 0
    monkeypatch.setattr(wb, "warp_sample_bounded_forward", fwd)
    monkeypatch.setattr(wb, "warp_sample_bounded_grad_grid", grad)
    return wb


@pytest.mark.parametrize("model", ["rrin", "superslomo", "voxelflow"])
def test_warp_model_episode_launches_what_is_derived(counted_warp, model):
    """One 64x64 episode of each preset on the CPU, with the plain sampler
    forbidden outside the counted wrappers (so no plain image gradient
    runs): the launches chip_smoke.py holds the card to."""
    import torch

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    wb = counted_warp
    flags, k3, k3g = chip_smoke.WARP_MODELS[model]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = SceneAdaptiveInterpolation(get_args(flags + ["--device",
                                                              "cpu"]))
        clip = SyntheticSeptuplet(model=model, mode="val",
                                  size=(64, 64))[0][0][None]
        chip_smoke.plain_warp_forbidden(wb, system.run_validation_iter)(clip)
    finally:
        torch.set_num_threads(threads)
    assert wb.warp_sample_bounded_forward.launches == k3
    assert wb.warp_sample_bounded_grad_grid.launches == k3g


def test_plain_warp_forbidden_raises_on_an_image_gradient_and_restores():
    import torch

    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    real = wb.grid_sample_bounded_ref
    img = torch.rand(1, 2, 5, 6, requires_grad=True)
    grid = torch.rand(1, 5, 6, 2) * 2 - 1

    def run():
        wb.GridSampleBoundedFunction.apply(img, grid, 2, False,
                                           "zeros").sum().backward()
    with pytest.raises(AssertionError, match="plain bounded-sampler"):
        chip_smoke.plain_warp_forbidden(wb, run)()
    assert wb.grid_sample_bounded_ref is real


@pytest.mark.parametrize("model", ["rrin", "superslomo", "voxelflow"])
def test_exact_episode_samples_once_a_bounded_launch(model):
    """The exact path's episode samples (FlowStats' calls) as often as the
    bounded path launches K3: warp_model_phase holds FlowStats to it."""
    import torch

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.ops import warp as warp_ops
    flags, k3, _ = chip_smoke.WARP_MODELS[model]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = SceneAdaptiveInterpolation(get_args(
            flags + ["--fast_warp_range", "0", "--device", "cpu"]))
        clip = SyntheticSeptuplet(model=model, mode="val",
                                  size=(64, 64))[0][0][None]
        with warp_ops.FlowStats(r=chip_smoke.WARP_R) as fs:
            system.run_validation_iter(clip)
    finally:
        torch.set_num_threads(threads)
    assert system.model.warp_range is None
    assert fs.calls == k3 and fs.n_total > 0


def test_peak_blocks_replays_the_trace_to_its_peak():
    """Blocks a (100) and b (300) live together at the peak of 400; c (50)
    comes after a is freed, so it is not live there."""
    def alloc(addr, size, name):
        return {"action": "alloc", "addr": addr, "size": size, "frames": [
            {"filename": "/x/torch/nn/functional.py", "line": 1,
             "name": "conv2d"},
            {"filename": "/x/meta_interpolation_tpu_torch/models/m.py",
             "line": 7, "name": name}]}
    trace = [alloc(1, 100, "a"), alloc(2, 300, "b"),
             {"action": "free_requested", "addr": 1, "size": 100},
             {"action": "free_completed", "addr": 1, "size": 100},
             alloc(3, 50, "c")]
    peak, blocks = chip_smoke.peak_blocks(trace)
    assert peak == 400
    assert blocks == [(300, "functional.py:1 conv2d", "m.py:7 b"),
                      (100, "functional.py:1 conv2d", "m.py:7 a")]


def _script_flags(name):
    """The flags of scripts/<name> (the JAX package's presets), as
    {flag: value or True}."""
    words = (ROOT / "scripts" / name).read_text().replace("\\\n", " ").split()
    flags, i = {}, words.index("meta_interpolation_tpu.main") + 1
    while i < len(words) and words[i].startswith("--"):
        if i + 1 < len(words) and not words[i + 1].startswith("--") \
                and words[i + 1] != '"$@"':
            flags[words[i]] = words[i + 1].strip('"')
            i += 2
        else:
            flags[words[i]] = True
            i += 1
    return flags


def _as_dict(flags):
    out, i = {}, 0
    while i < len(flags):
        if i + 1 < len(flags) and not flags[i + 1].startswith("--"):
            out[flags[i]] = flags[i + 1]
            i += 2
        else:
            out[flags[i]] = True
            i += 1
    return out


def test_cain_and_test_mode_presets_are_the_scripts():
    """CAIN's phases run run_cain.sh's hyperparameters (its batch in
    training, --val_batch_size 1 in evaluation), the test-mode phase
    run_test.sh's; the script's run-length and logging flags aside."""
    cain = _script_flags("run_cain.sh")
    for flags in (chip_smoke.CAIN_EVAL_FLAGS, chip_smoke.CAIN_TRAIN_FLAGS):
        got = _as_dict(flags)
        for flag in ("--model", "--loss", "--optimizer", "--inner_lr",
                     "--outer_lr", "--val_batch_size", "--metasgd",
                     "--number_of_training_steps_per_iter",
                     "--number_of_evaluation_steps_per_iter"):
            assert got[flag] == cain[flag], flag
    assert _as_dict(chip_smoke.CAIN_TRAIN_FLAGS)["--batch_size"] == cain[
        "--batch_size"] == str(chip_smoke.CAIN_TASKS)
    test = _script_flags("run_test.sh")
    got = _as_dict(chip_smoke.TEST_FLAGS + chip_smoke.TEST_MODELS["cain"])
    for flag in ("--model", "--mode", "--dataset", "--img_fmt",
                 "--number_of_evaluation_steps_per_iter"):
        assert got[flag] == test[flag], flag
    assert (chip_smoke.K1_PER_TEST_CLIP, chip_smoke.K2_PER_TEST_CLIP) == (6,
                                                                          4)


@pytest.fixture
def counted_sepconv(monkeypatch):
    """The K1 and K2 wrappers counting on the CPU around their plain
    versions."""
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    ref, grad_ref = sc.sepconv_ref, sc.grad_kernels_ref

    def fwd(inp, kv, kh):
        fwd.launches += 1
        return ref(inp, kv, kh)

    def grad(inp, g, kv, kh):
        grad.launches += 1
        return grad_ref(inp, g, kv, kh)
    fwd.launches = grad.launches = 0
    monkeypatch.setattr(sc, "sepconv_forward", fwd)
    monkeypatch.setattr(sc, "sepconv_grad_kernels", grad)
    return sc


def test_sepconv_test_clip_launches_what_is_derived(counted_sepconv):
    """One SepConv test clip on the CPU (run_test.sh with Adamax and
    Meta-SGD, 1 step): 4n + 2 K1 and 4n K2, the counts chip_smoke.py holds
    the card to."""
    import numpy as np
    import torch

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    sc = counted_sepconv
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        system = SceneAdaptiveInterpolation(get_args(
            chip_smoke.TEST_FLAGS + chip_smoke.TEST_MODELS["sepconv"]
            + ["--device", "cpu"]))
        clip = SyntheticSeptuplet(mode="test", size=(32, 32))[0][0]
        preds = system.run_test_iter(np.asarray(clip)[None, :4])
    finally:
        torch.set_num_threads(threads)
    assert preds.shape == (1, 3, 32, 32)
    assert sc.sepconv_forward.launches == chip_smoke.K1_PER_TEST_CLIP
    assert sc.sepconv_grad_kernels.launches == chip_smoke.K2_PER_TEST_CLIP


def test_test_mode_names_are_what_the_writer_gives(tmp_path, monkeypatch):
    """The test-mode phase's expected names, from the port's CLI on a tiny
    CAIN over TEST_FRAMES frames written as the phase writes them (the
    CLI's names are held to the JAX package's in test_torch_test_mode.py):
    the inputs renamed, then x2, then x4 on that output."""
    import os

    import torch

    monkeypatch.setattr(chip_smoke, "TEST_FLAGS", chip_smoke.TEST_FLAGS + [
        "--depth", "2", "--n_resblocks", "1"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = str(tmp_path / "frames")
        chip_smoke.write_frames(d, (16, 24), chip_smoke.TEST_FRAMES)
        seen = []
        for run in ("x2", "x4"):
            count = chip_smoke.run_test_mode(
                chip_smoke.TEST_MODELS["cain"], d, "cpu")
            assert count == len(chip_smoke.TEST_NAMES[run])
            seen += chip_smoke.TEST_NAMES[run]
            assert sorted(os.listdir(d)) == sorted(chip_smoke.TEST_INPUTS
                                                   + seen)
    finally:
        torch.set_num_threads(threads)


def test_timed_returns_what_it_ran_and_prints_its_time(capsys):
    assert chip_smoke.timed("phase", lambda a, b=0: a + b, 2, b=3) == 5
    assert capsys.readouterr().out.startswith("[time] phase: ")


K3GG = "_ZN12_GLOBAL__N_137warp_sample_grad_grid_backward_kernelILi3EEEvPKfPK6float2S2_S5_PfPS3_iiiibb"
K3G = "_ZN12_GLOBAL__N_128warp_sample_grad_grid_kernelILi3EEEvPKfPK6float2S2_PS3_iiiibb"
K3G_TILE = "_ZN12_GLOBAL__N_131warp_grad_grid_bf16_tile_kernelILi3EEEvPK13__nv_bfloat16PK6float2S3_PS4_iiiiibb"
K3GG_TILE = "_ZN12_GLOBAL__N_140warp_grad_grid_backward_bf16_tile_kernelILi3EEEvPK13__nv_bfloat16PK6float2S3_S6_PS4_PS5_iiiiibb"


def test_kernel_resources_tell_k3_grad_from_its_derivative():
    """K3-grad's ptxas entry name is not a part of K3-grad²'s, nor the bf16
    tile kernels' of each other's: each wrapper reads its own kernel's
    registers."""
    log = ""
    for name, regs in ((K3G, 56), (K3GG, 64), (K3G_TILE, 48),
                       (K3GG_TILE, 60)):
        log += f"""ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers
"""
    entries = {k: v for k, v in chip_smoke.WARP_KERNELS.items()
               if "grad_grid" in k}
    res = chip_smoke.kernel_resources(log, "warp.cu", entries)
    assert res["warp_sample_bounded_grad_grid"]["registers"] == 56
    assert res["warp_sample_bounded_grad_grid_backward"]["registers"] == 64
    assert res["warp_sample_bounded_grad_grid_bf16"]["registers"] == 48
    assert res["warp_sample_bounded_grad_grid_backward_bf16"][
        "registers"] == 60


@pytest.mark.parametrize("steps,warps,second,want", [
    (0, 2, False, (2, 2, None)),          # RRIN as run_rrin.sh: a fine-tune
    (1, 6, False, (18, 18, None)),        # SuperSloMo
    (1, 6, True, (18, 30, 12)),           # SuperSloMo, second order
    (1, 2, True, (6, 10, 4)),             # VoxelFlow, RRIN at 1 step
])
def test_train_launches_per_task(steps, warps, second, want):
    got = chip_smoke.train_launches(steps, warps, second)
    assert (got["warp_sample_bounded_forward"],
            got["warp_sample_bounded_grad_grid"],
            got.get("warp_sample_bounded_grad_grid_backward")) == want


def _inner_dist():
    return dict.fromkeys(("d2", "n2", "flips", "n"), 0)


def test_handing_inner_steps_the_cpu_with_the_cards_support_gradients():
    """Adamax's first step lr·g/(|g| + 1e-8) is a sign away from 0: two
    gradients a rounding apart around 0 step the other way. Handed, the CPU
    takes the card's step; its own gradients are measured, not used."""
    import torch

    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    opt = InnerOptimizer(rule="Adamax", lr_mode="metasgd")
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, generator=gen)}
    lrs = opt.init_lrs(params, 1e-3)
    card_g = {"w": torch.randn(64, generator=gen) * 1e-6}
    cpu_g = {"w": card_g["w"] + torch.randn(64, generator=gen) * 1e-6}
    step = lambda fn, g: fn(opt, params, g, lrs, opt.init_state(params), 0)
    record, dist = [], _inner_dist()
    want = step(InnerOptimizer.update, card_g)[0]["w"]
    card = chip_smoke.handing_inner(torch, InnerOptimizer.update, record,
                                    "cuda", dist)
    cpu = chip_smoke.handing_inner(torch, InnerOptimizer.update, record,
                                   "cpu", dist)
    assert torch.equal(step(card, card_g)[0]["w"], want) and len(record) == 1
    assert torch.equal(step(cpu, cpu_g)[0]["w"], want) and not record
    own = step(InnerOptimizer.update, cpu_g)[0]["w"]
    flips = int((torch.sign(cpu_g["w"]) != torch.sign(card_g["w"])).sum())
    assert flips > 0 and not torch.equal(own, want)
    assert dist == {"d2": pytest.approx(float((cpu_g["w"] - card_g["w"])
                                              .norm()) ** 2),
                    "n2": pytest.approx(float(cpu_g["w"].norm()) ** 2),
                    "flips": flips, "n": 64}
    with pytest.raises(AssertionError, match="more inner steps"):
        step(cpu, cpu_g)
    record.append(card_g)
    with pytest.raises(AssertionError, match="cut the second order"):
        step(cpu, {"w": cpu_g["w"].requires_grad_()})


def test_handing_inner_in_a_first_order_episode_changes_nothing_alike():
    """A tiny CAIN's first-order outer gradient under inner Adamax: the
    stand-ins take every inner step of the episode, and handed the very
    gradients the CPU computes itself, its outer gradients are bit for bit
    the episode's without them."""
    import torch

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    torch.manual_seed(0)
    cfg = get_args(["--model", "cain", "--depth", "2", "--n_resblocks", "1",
                    "--mode", "train", "--optimizer", "Adamax", "--metasgd",
                    "--inner_lr", "1e-3", "--loss", "1*L1", "--batch_size",
                    "1", "--number_of_training_steps_per_iter", "2"])
    clip = SyntheticSeptuplet(model="cain", mode="train",
                              size=(32, 32))[0][0][None]
    system = SceneAdaptiveInterpolation(cfg, device="cpu")
    real = InnerOptimizer.update
    record, dist, out = [], _inner_dist(), []
    for dev in ("plain", "cuda", "cpu"):
        run = lambda: system.outer_grads(clip, 0)
        if dev != "plain":
            run = chip_smoke.with_attr(
                InnerOptimizer, "update",
                chip_smoke.handing_inner(torch, real, record, dev, dist), run)
        loss, _, grads = run()
        out.append((float(loss), grads))
        if dev == "cuda":
            assert len(record) == 2
    assert InnerOptimizer.update is real and not record
    assert dist["d2"] == 0 and dist["flips"] == 0 and dist["n2"] > 0
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        for g in ("net", "lrs"):
            assert all(torch.equal(v, out[0][1][g][k])
                       for k, v in grads[g].items())


def _tiny_cain(order):
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    cfg = get_args(["--model", "cain", "--depth", "2", "--n_resblocks", "1",
                    "--mode", "train", "--optimizer", "Adamax", "--metasgd",
                    "--inner_lr", "1e-3", "--loss", "1*L1", "--batch_size",
                    "1", "--number_of_training_steps_per_iter", "1"]
                   + (["--second_order"] if order == "second" else []))
    clip = SyntheticSeptuplet(model="cain", mode="train",
                              size=(32, 32))[0][0][None]
    return SceneAdaptiveInterpolation(cfg, device="cpu"), clip


def test_handing_inner_keeps_the_tape_in_second_order():
    """A tiny CAIN's second-order outer gradient under inner Adamax: handed
    the very support gradients it computes itself with ``keep_tape`` (their
    values, its own derivative), the outer gradients are bit for bit the
    episode's without the stand-ins; without ``keep_tape`` the hand-over
    refuses."""
    import torch

    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    system, clip = _tiny_cain("second")
    real = InnerOptimizer.update
    record, dist, out = [], _inner_dist(), []
    for dev in ("plain", "cuda", "cpu"):
        run = lambda: system.outer_grads(clip, 0)
        if dev != "plain":
            run = chip_smoke.with_attr(
                InnerOptimizer, "update", chip_smoke.handing_inner(
                    torch, real, record, dev, dist, keep_tape=True), run)
        loss, _, grads = run()
        out.append((float(loss), grads))
    assert not record and dist["d2"] == 0 and dist["n2"] > 0
    for loss, grads in out[1:]:
        assert loss == out[0][0]
        for g in ("net", "lrs"):
            assert all(torch.equal(v, out[0][1][g][k])
                       for k, v in grads[g].items())
    record.append({k: v.detach() for k, v in out[0][1]["net"].items()})
    with pytest.raises(AssertionError, match="cut the second order"):
        chip_smoke.with_attr(InnerOptimizer, "update", chip_smoke.handing_inner(
            torch, real, record, "cpu", _inner_dist()),
            lambda: system.outer_grads(clip, 0))()


def test_to_float64_recasts_the_whole_step():
    """The recast system's outer loss and gradients are float64, and
    within float32's rounding of the float32 system's."""
    import torch
    system, clip = _tiny_cain("first")
    loss32, _, grads32 = system.outer_grads(clip, 0)
    loss, _, grads = chip_smoke.to_float64(torch, system).outer_grads(clip, 0)
    assert all(v.dtype == torch.float64 for g in grads.values()
               for v in g.values())
    assert abs(float(loss) - float(loss32)) <= 1e-5 * abs(float(loss))
    for k, v in grads["net"].items():
        assert float((v - grads32["net"][k].double()).norm()) <= \
            1e-3 * float(v.norm()) + 1e-12, k


@pytest.mark.parametrize("model,order,want", [
    ("sepconv", "first", (14, 14, 0, 0, 0)),
    ("sepconv", "second", (38, 38, 0, 0, 0)),
    ("rrin", "first", (0, 0, 2, 2, 0)),
    ("rrin", "second", (0, 0, 6, 10, 4)),
    ("superslomo", "first", (0, 0, 18, 18, 0)),
    ("superslomo", "second", (0, 0, 18, 30, 12)),
    ("voxelflow", "first", (0, 0, 6, 6, 0)),
    ("voxelflow", "second", (0, 0, 6, 10, 4)),
    ("cain", "first", (0, 0, 0, 0, 0))])
def test_spatial_train_launches_are_one_process_s(model, order, want):
    """A rank's launches a task (K1, K2, K3, K3-grad, K3-grad²) on each
    row-sharded training path: one process's (12n + 2 K1 and K2 a
    second-order SepConv task; K3-grad² 2n·w a second-order warp-model
    task, RRIN's second order at 1 inner step), none elsewhere."""
    got = chip_smoke.spatial_train_launches(model, order)
    assert got == dict(zip(chip_smoke.KERNELS[:5], want))


def test_spatial_train_flags_are_the_presets_at_one_task():
    from meta_interpolation_tpu_torch.config import get_args
    for model, (_, steps, _, orders) in chip_smoke.SPATIAL_TRAIN.items():
        for order in orders:
            cfg = get_args(chip_smoke.spatial_train_flags(model, order)
                           + chip_smoke.SPATIAL_FLAGS)
            assert (cfg.model, cfg.mode, cfg.batch_size, cfg.crop_size,
                    cfg.spatial_shards, cfg.mesh_shape) == (
                model, "train", 1, 256, 2, "1x2")
            assert cfg.second_order == (order == "second")
            assert cfg.num_inner_steps == (max(steps, 1) if order == "second"
                                           else steps)
            assert cfg.fast_warp_range == (
                8 if model in chip_smoke.WARP_MODELS else 0)
    cli = get_args(chip_smoke.SPATIAL_TRAIN_CLI + chip_smoke.SPATIAL_FLAGS)
    assert (cli.model, cli.mode, cli.batch_size, cli.max_epoch,
            cli.total_iter_per_epoch, cli.spatial_shards) == (
        "voxelflow", "train", 1, 1, 1, 2)


def test_grad2_band_cases_cover_each_setting():
    """K3-grad²'s band entry is held at both paddings, align_corners both
    ways, R = 4 and 8, C = 3 and 5, on 4 bands each: at least 8 cases."""
    assert set(chip_smoke.GRAD2_BAND_RANGES) == {4, 8}
    assert 3 in chip_smoke.GRAD2_BAND_CHANNELS and any(
        c != 3 for c in chip_smoke.GRAD2_BAND_CHANNELS)
    cases = (len(chip_smoke.GRAD2_BAND_RANGES)
             * len(chip_smoke.GRAD2_BAND_CHANNELS) * 2 * 2 * 4)
    assert cases >= 8
