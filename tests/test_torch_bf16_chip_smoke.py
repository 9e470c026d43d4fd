"""chip_smoke.py's ``bf16`` phase, the parts that run on the CPU: its bar
for the bf16 kernels, its guard against the float32 entry points, its
presets (bench.py's serving batches and options, the episodes' and train
iterations' launches), and the launches of a served bf16 forward and a
bf16 episode counted on the CPU with counting wrappers.
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_bf16",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("top,ulp", [(1.0, 2 ** -7), (1.99, 2 ** -7),
                                     (96.0, 0.5), (0.3, 2 ** -9)])
def test_bf16_ulp_is_that_of_the_largest_value(top, ulp):
    t = torch.tensor([0.1, -top, top / 2])
    assert chip_smoke.bf16_ulp(t) == ulp
    want = torch.tensor([0.0, top])
    chip_smoke.bf16_err(torch.tensor([ulp, top]), want, "within")
    with pytest.raises(AssertionError, match="over"):
        chip_smoke.bf16_err(torch.tensor([0.0, top + 2 * ulp]), want,
                            "over")


def test_bitwise_tells_type_and_value():
    a = torch.tensor([1.0, 2.0], dtype=torch.bfloat16)
    chip_smoke.bitwise(torch, a, a.clone(), "same")
    with pytest.raises(AssertionError, match="not bit for bit"):
        chip_smoke.bitwise(torch, a, a.float(), "type")
    with pytest.raises(AssertionError, match="not bit for bit"):
        chip_smoke.bitwise(torch, a, a + 1, "value")


def test_f32_forbidden_raises_only_on_the_named_entry_points():
    class Lib:
        sepconv_forward = "f32"
        sepconv_forward_bf16 = "bf16"
    lib = chip_smoke.F32Forbidden(Lib(), ("sepconv_forward",))
    assert lib.sepconv_forward_bf16 == "bf16"
    with pytest.raises(AssertionError, match="float32 sepconv_forward"):
        lib.sepconv_forward


def test_f32_forbidden_names_what_it_forbids():
    class Lib:
        warp_sample_bounded_forward_bf16_gather = "gather"
        warp_sample_bounded_forward_bf16 = "tile"
    lib = chip_smoke.F32Forbidden(Lib(), chip_smoke.GATHER_AS_BF16,
                                  "the gather route's")
    assert lib.warp_sample_bounded_forward_bf16 == "tile"
    with pytest.raises(AssertionError, match="the gather route's warp"):
        lib.warp_sample_bounded_forward_bf16_gather


def test_renamed_runs_one_route_on_the_other():
    """TILE_AS_GATHER: the checkout's gather kernels where the wrapper
    calls the tiled ones; GATHER_AS_BF16: an earlier source's one bf16
    kernel on both routes."""
    class Lib:
        warp_sample_bounded_forward = "f32"
        warp_sample_bounded_forward_bf16 = "tile"
        warp_sample_bounded_forward_bf16_gather = "gather"
        warp_sample_bounded_grad_grid_bf16 = "grad tile"
        warp_sample_bounded_grad_grid_bf16_gather = "grad gather"
    gather = chip_smoke.Renamed(Lib(), chip_smoke.TILE_AS_GATHER)
    assert gather.warp_sample_bounded_forward_bf16 == "gather"
    assert gather.warp_sample_bounded_grad_grid_bf16 == "grad gather"
    assert gather.warp_sample_bounded_forward == "f32"
    earlier = chip_smoke.Renamed(Lib(), chip_smoke.GATHER_AS_BF16)
    assert earlier.warp_sample_bounded_forward_bf16_gather == "tile"
    assert earlier.warp_sample_bounded_grad_grid_bf16_gather == "grad tile"


def test_bf16_gather_cases_take_the_gather_route():
    """Both bf16 routes are held on the card: the warp cases on the tiled
    kernels, BF16_GATHER_CASES on the gather ones; the timed batches on the
    tiled ones."""
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    route = lambda case: wb.bf16_window(*case[:4], case[7]).route
    assert {route(c) for c in chip_smoke.warp_cases()} == {"tile"}
    assert {route(c) for c in chip_smoke.BF16_GATHER_CASES} == {"gather"}
    assert chip_smoke.BF16_WARP_BATCHES == (1, 8)
    for n in chip_smoke.BF16_WARP_BATCHES:
        assert wb.bf16_window(n, 3, 256, 512, chip_smoke.WARP_R).route \
            == "tile"


def test_serving_presets_are_bench_pys():
    """The batches and options of ``bench.py --model`` and of its CAIN
    serving headline."""
    text = (ROOT / "bench.py").read_text()
    best = re.search(r"best_batch = (\{[^}]*\})", text).group(1)
    batches = eval(best)   # a dict literal of the script's
    default = int(re.search(r"best_batch\.get\(name, (\d+)\)",
                            text).group(1))
    serve = chip_smoke.BF16_SERVE
    for model in ("rrin", "voxelflow", "superslomo", "dain", "sepconv"):
        assert serve[model][0] == batches.get(model, default), model
    assert re.search(r"def bench_cain_interp_fps\(height=256, width=448, "
                     r"batch=(\d+)", text).group(1) == str(serve["cain"][0])
    assert serve["cain"][1] == {"pad_multiple": 8, "fuse_pad": True}
    assert serve["dain"][2] == {"proj_range": 8, "fill_holes": True}
    for model in ("rrin", "voxelflow", "superslomo"):
        assert serve[model][1] == {"warp_range": 8}
    assert chip_smoke.FULL_HW == (256, 448)


def test_bf16_paths_are_the_presets_with_their_launches():
    assert set(chip_smoke.BF16_EVAL) == set(chip_smoke.BF16_TRAIN) == {
        "sepconv", "rrin", "superslomo", "voxelflow", "dain", "cain"}
    assert chip_smoke.BF16_EVAL["sepconv"][1] == {
        "sepconv_forward": 14, "sepconv_grad_kernels": 12}
    assert chip_smoke.BF16_EVAL["rrin"][1] == {
        "warp_sample_bounded_forward": 6, "warp_sample_bounded_grad_grid": 4}
    assert chip_smoke.BF16_TRAIN["sepconv"][1:] == (
        3, {"sepconv_forward": 42, "sepconv_grad_kernels": 42})
    assert chip_smoke.BF16_TRAIN["superslomo"][1:] == (
        4, {"warp_sample_bounded_forward": 72,
            "warp_sample_bounded_grad_grid": 72})
    assert chip_smoke.BF16_TRAIN["dain"][2] == {}
    assert chip_smoke.BF16_KERNELS == chip_smoke.KERNELS[:4]


@pytest.fixture
def counted(monkeypatch):
    """The K1 and K3 wrappers counting on the CPU (their plain versions
    with the kernels' bf16 semantics run)."""
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    calls = {}
    for mod, name in ((sc, "sepconv_forward"), (sc, "sepconv_grad_kernels"),
                      (wb, "warp_sample_bounded_forward"),
                      (wb, "warp_sample_bounded_grad_grid")):
        real = getattr(mod, name)

        def run(*args, _real=real, _name=name, **kw):
            assert args[0].dtype == torch.bfloat16, _name
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, run)
    return calls


@pytest.mark.parametrize("model", ["rrin", "voxelflow", "sepconv"])
def test_served_bf16_forward_launches_what_is_derived(counted, model,
                                                      one_thread):
    batch, kwargs, fwd_kw, per_fwd = chip_smoke.BF16_SERVE[model]
    net = chip_smoke.serve_model(model, torch.Generator().manual_seed(0),
                                 kwargs).to(torch.bfloat16)
    f0, f1 = (torch.rand(1, 3, 32, 32).to(torch.bfloat16) for _ in "01")
    with torch.no_grad():
        out = net(f0, f1, **fwd_kw)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 32, 32)
    assert counted == per_fwd


def test_bf16_sepconv_episode_launches_what_float32_does(counted,
                                                         one_thread):
    """A 32x32 clip of chip_smoke.py's SepConv evaluation preset in bf16:
    every K1/K2 call takes bf16, as many as the float32 path launches."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    flags, per_clip = chip_smoke.BF16_EVAL["sepconv"]
    system = SceneAdaptiveInterpolation(get_args(
        flags + chip_smoke.BF16 + ["--device", "cpu",
                                   "--number_of_evaluation_steps_per_iter",
                                   "1"]))
    clip = SyntheticSeptuplet(model="sepconv", mode="val",
                              size=(32, 32))[0][0][None]
    system.run_validation_iter(clip)
    assert counted == {"sepconv_forward": 6, "sepconv_grad_kernels": 4}
    assert per_clip == {"sepconv_forward": 14, "sepconv_grad_kernels": 12}


@pytest.mark.parametrize("card,fp32,bw,bf16", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", 67.0e12, 3.35e12, 989e12),
    ("NVIDIA H100 PCIe, 350.00 W", 51.2e12, 2.0e12, 756e12),
    ("NVIDIA H100 NVL, 400.00 W", 60.0e12, 3.9e12, 835e12),
    ("NVIDIA H200, 700.00 W", 67.0e12, 4.8e12, 989e12)])
def test_peaks_give_the_bf16_tensor_core_rate_beside_fp32(card, fp32, bw,
                                                           bf16):
    """K1/K2 in bf16 are bound at the dense bf16 tensor-core rate, the
    other kernels at the fp32 rate (data sheets)."""
    assert chip_smoke.peaks(card) == (fp32, bw)
    assert chip_smoke.bf16_tensor_peak(card) == bf16


def test_bf16_sepconv_kernel_names_are_the_sources():
    text = (ROOT / "meta_interpolation_tpu_torch" / "csrc"
            / "sepconv.cu").read_text()
    for entry, kernel in chip_smoke.BF16_SEPCONV_KERNELS.items():
        assert f'extern "C" int {entry}(' in text
        assert f"\n{kernel}(" in text
    assert 0 < chip_smoke.BF16_FLIP_SHARE <= 1e-2


def test_deterministic_sets_and_restores_the_flags():
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    with chip_smoke.deterministic(torch, True):
        assert torch.backends.cudnn.deterministic
        assert torch.are_deterministic_algorithms_enabled()
    assert (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled()) == saved
    with chip_smoke.deterministic(torch, False):
        assert torch.backends.cudnn.deterministic
        assert (torch.are_deterministic_algorithms_enabled() == saved[1])
    assert set(chip_smoke.BF16_BITWISE) <= set(chip_smoke.BF16_CARD_VS_CPU)


class _Dain(torch.nn.Module):
    """DAIN's three handed steps in miniature: a depth net, flows and a
    projection of the flows (models/dain/model.py's names)."""

    def __init__(self, scale):
        super().__init__()
        self.depthNet = torch.nn.Linear(4, 4)
        self.scale = scale

    def flows(self, x0, x2):
        return x0 * self.scale, x2 * self.scale

    def forward(self, x):
        from meta_interpolation_tpu_torch.models.dain import model as dain
        depth = self.depthNet(x)
        f0, f2 = self.flows(x, x + 1)
        return depth + f0 + f2 + dain.flow_projection(f0, depth)


def test_bf16_card_vs_cpu_hands_dain_its_flows_depths_and_offsets(
        monkeypatch):
    """The bf16 card-vs-CPU phase holds DAIN with its CPU run handed the
    card run's PWC flows, log depths and projected offsets, call by call:
    exactly those, every one of them, and no more."""
    from types import SimpleNamespace

    from meta_interpolation_tpu_torch.models.dain import model as dain
    assert "dain" in chip_smoke.BF16_CARD_VS_CPU
    assert chip_smoke.DAIN_HANDED == ("flows", "log depth", "offsets")
    monkeypatch.setattr(dain, "flow_projection",
                        lambda flow, depth, **kw: flow * depth)
    x = torch.arange(8.0).reshape(2, 4)
    record = {kind: [] for kind in chip_smoke.DAIN_HANDED}
    card = SimpleNamespace(model=_Dain(1.0))
    want = chip_smoke.dain_handing(torch, record, "cuda", card,
                                   lambda: card.model(x))
    assert {k: len(v) for k, v in record.items()} == dict.fromkeys(
        chip_smoke.DAIN_HANDED, 1)
    # a CPU model with other weights gives the card's result, handed
    cpu = SimpleNamespace(model=_Dain(2.0))
    got = chip_smoke.dain_handing(torch, record, "cpu", cpu,
                                  lambda: cpu.model(x))
    assert torch.equal(got, want) and not any(record.values())
    assert not torch.equal(cpu.model(x), want)      # unhanded it differs
    with pytest.raises(AssertionError, match="takes more log depth"):
        chip_smoke.dain_handing(torch, record, "cpu", cpu,
                                lambda: cpu.model(x))
    for _ in range(2):
        chip_smoke.dain_handing(torch, record, "cuda", card,
                                lambda: card.model(x))
    with pytest.raises(AssertionError, match="left"):
        chip_smoke.dain_handing(torch, record, "cpu", cpu,
                                lambda: cpu.model(x))
