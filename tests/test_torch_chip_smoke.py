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
