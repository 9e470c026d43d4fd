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
