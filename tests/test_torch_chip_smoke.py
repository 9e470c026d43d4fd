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
    shapes; every displacement kind; C = 3 and another C, N = 1 and 2; the
    main-path shape at R = 8."""
    cases = chip_smoke.warp_cases()
    assert {(c[8], c[9]) for c in cases} == {
        (a, p) for a in (False, True) for p in ("zeros", "border")}
    assert {c[7] for c in cases} == {1, 3, 8}
    assert {c[6] for c in cases} == {"uniform", "integer", "outside"}
    assert {c[:2] for c in cases} == {(1, 3), (2, 2)}
    assert (1, 3, 256, 512, -8, 7, "uniform", 8, False, "zeros") in cases
    assert any(c[5] > c[7] for c in cases)   # displacements past R
