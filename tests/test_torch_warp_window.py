"""The tap window of the bf16 K3 / K3-grad / K3-grad² tile kernels, on the
CPU.

csrc/warp.cu's bf16 kernels stage each block's tap window in shared memory
and read every tap from there, so they are right only if every tap the
sampler reads for an output pixel lies inside the window of that pixel's
tile. Held here on the plain sampler's own tap indices
(``ops/warp_bounded._axis``, the floors, the edge clamp) over grids within
R, past R, far outside the image and at ±1e30; and the route function
(``bf16_window``) that sends what does not fit to the gather kernels, with
its constants read from the kernel source; the entry point each call
takes, the binding, the counters, and the bf16 K3-grad² on the CPU.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meta_interpolation_tpu_torch.ops import warp_bounded as wb


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread while this file runs: the tier-1 run puts six
    test files side by side on one host, and a thread per core each slows
    every file down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SRC = (Path(__file__).resolve().parents[1] / "meta_interpolation_tpu_torch"
       / "csrc" / "warp.cu")


def _grid(kind, n, h, w, r, align, seed):
    """A grid (N, H, W, 2) whose coordinates are displaced from their pixel
    within [−R, R) ("within"), up to 3R + 2 past it ("past"), anywhere in
    five frames around the image ("outside"), or at ±1e30 ("huge")."""
    rng = np.random.default_rng(seed)
    size = np.array([w, h], dtype=np.float64)
    if kind == "huge":
        return torch.from_numpy(rng.choice([-1e30, 1e30], (n, h, w, 2))
                                ).float()
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], -1)[None].astype(np.float64)
    shape = (n, h, w, 2)
    if kind == "within":
        coord = pos + rng.uniform(-r, r, shape)
    elif kind == "past":
        coord = pos + rng.uniform(-3 * r - 2, 3 * r + 2, shape)
    else:
        coord = rng.uniform(-2, 3, shape) * size
    if align:
        return torch.from_numpy(2 * coord / (size - 1) - 1).float()
    return torch.from_numpy((2 * coord + 1) / size - 1).float()


def _taps(grid, h, w, r, align, border):
    """The rows and columns (each (N, H, W), two of each) of the four taps
    the plain sampler reads for every output pixel."""
    ix, iy = wb._unnormalize(grid, h, w, align)
    xs = torch.arange(w, dtype=ix.dtype)[None, None, :]
    ys = torch.arange(h, dtype=ix.dtype)[None, :, None]
    dx0 = wb._axis(ix, xs, w, r, border)[0].long()
    dy0 = wb._axis(iy, ys, h, r, border)[0].long()
    xs, ys = xs.long(), ys.long()
    rows = [(ys + dy0 + k).clamp(0, h - 1) for k in (0, 1)]
    cols = [(xs + dx0 + k).clamp(0, w - 1) for k in (0, 1)]
    return rows, cols


def _spans(size, length, r):
    """(first, last) staged index of each output index's tile, as tensors."""
    spans = [wb.window_span(i // length, length, r, size)
             for i in range(size)]
    first, last = zip(*spans)
    return torch.tensor(first), torch.tensor(last)


@pytest.mark.parametrize("h, w", [(37, 53), (256, 448)])
@pytest.mark.parametrize("r", [1, 3, 8, 33])
@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("kind", ["within", "past", "outside", "huge"])
def test_every_tap_lies_in_its_tiles_window(kind, padding, align, r, h, w):
    th, tw = wb.BF16_TILE
    grid = _grid(kind, 2, h, w, r, align, seed=h + 7 * r + 3 * align)
    rows, cols = _taps(grid, h, w, r, align, padding == "border")
    row_first, row_last = _spans(h, th, r)
    col_first, col_last = _spans(w, tw, r)
    for row in rows:
        assert bool((row >= row_first[None, :, None]).all())
        assert bool((row <= row_last[None, :, None]).all())
    for col in cols:
        assert bool((col >= col_first[None, None, :]).all())
        assert bool((col <= col_last[None, None, :]).all())
    # every block's window fits the shared memory the launch sizes
    win = wb.bf16_window(2, 3, h, w, r)
    assert int((row_last - row_first).max()) + 1 <= win.rows
    assert int((col_last - col_first).max()) + 1 <= win.cols
    assert win.cols % 8 == 0
    assert win.shared_bytes == win.rows * win.cols * wb.TEXEL_BYTES


@pytest.mark.parametrize("shape, r, want", [
    ((1, 3, 256, 512), 8, ("tile", 32, 48, 12288)),     # RRIN's frame
    ((8, 3, 256, 512), 8, ("tile", 32, 48, 12288)),     # its served batch
    ((1, 3, 256, 448), 33, ("tile", 82, 104, 68224)),   # over 48 KB
    ((1, 3, 37, 53), 100, ("tile", 37, 56, 16576)),     # clipped to the image
    ((1, 4, 4096, 4096), 72, ("tile", 160, 176, 225280)),
    ((1, 3, 4096, 4096), 73, ("gather", 162, 184, 238464)),  # past 227 KB
    ((1, 3, 256, 448), 100, ("gather", 216, 232, 400896)),
    ((2, 5, 37, 53), 8, ("gather", 32, 48, 12288)),     # C > 4
    ((1, 3, 256, 256), 8, ("tile", 32, 48, 12288)),     # second order
    ((1, 3, 256, 448), 49, ("tile", 114, 136, 124032)),
    ((1, 3, 256, 448), 80, ("gather", 176, 192, 270336)),  # chip_smoke's
])
def test_route_sends_what_does_not_fit_to_the_gather_kernels(shape, r,
                                                             want):
    assert tuple(wb.bf16_window(*shape, r)) == want


def test_route_constants_are_the_kernels():
    """BF16_TILE, the texel and the shared-memory limit are csrc/warp.cu's
    (the launch sizes the window by the same rule)."""
    text = SRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))
    assert wb.BF16_TILE == (const("kTileH"), const("kTileW"))
    assert wb.TEXEL_CHANNELS == const("kTexelC")
    assert wb.MAX_WINDOW_BYTES == const("kMaxWindowBytes")
    # a texel is a uint2 of kTexelC bf16 values
    assert wb.TEXEL_BYTES == 2 * wb.TEXEL_CHANNELS
    assert re.search(r"const uint2 t = texels\[", text)
    # K3-grad²'s bf16 tile kernel is launched by the same rule
    assert re.search(r"int grad_grid_backward_tile\([^{]*\{\s*const auto "
                     r"kernel = c == 3 \? warp_grad_grid_backward_bf16_"
                     r"tile_kernel<3>[^}]*tile_launch\(kernel", text)


GRAD2 = "warp_sample_bounded_grad_grid_backward"
NAMES = ("warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
         GRAD2)


@pytest.mark.parametrize("name, dtype, c, r, want", [
    (NAMES[0], torch.float32, 3, 8, (NAMES[0], None)),
    (NAMES[0], torch.float32, 5, 8, (NAMES[0], None)),
    (NAMES[0], torch.bfloat16, 3, 8, (NAMES[0] + "_bf16", "tile")),
    (NAMES[0], torch.bfloat16, 4, 8, (NAMES[0] + "_bf16", "tile")),
    (NAMES[0], torch.bfloat16, 5, 8, (NAMES[0] + "_bf16_gather",
                                      "gather")),
    (NAMES[1], torch.bfloat16, 3, 8, (NAMES[1] + "_bf16", "tile")),
    (NAMES[1], torch.bfloat16, 3, 80, (NAMES[1] + "_bf16_gather",
                                       "gather")),
    # K3-grad²: its float32 kernel, or its bf16 tile kernel
    (GRAD2, torch.float32, 3, 8, (GRAD2, None)),
    (GRAD2, torch.float32, 5, 80, (GRAD2, None)),
    (GRAD2, torch.bfloat16, 3, 8, (GRAD2 + "_bf16", "tile")),
    (GRAD2, torch.bfloat16, 4, 49, (GRAD2 + "_bf16", "tile")),
])
def test_entry_point_follows_the_route(name, dtype, c, r, want):
    lib = SimpleNamespace(**{base + suffix: base + suffix
                             for base in NAMES
                             for suffix in ("", "_bf16", "_bf16_gather")})
    img = torch.zeros(1, c, 256, 448, dtype=dtype)
    assert wb._entry(lib, name, img, r) == want


@pytest.mark.parametrize("extra, grad2", [
    ((), ()),                             # a source from before bf16
    (("_bf16",), ()),                     # one bf16 kernel each way
    (("_bf16", "_bf16_gather"), ()),      # both routes of K3 and K3-grad
    (("_bf16", "_bf16_gather"), ("_bf16",)),  # and K3-grad²'s bf16 kernel
])
def test_bind_sets_every_bf16_entry_point_it_finds(extra, grad2):
    """The checkout's source has every bf16 entry point; an earlier source
    with today's C interface may have fewer: those it has are bound with
    their float32 counterpart's signature, and none is made up."""
    names = NAMES
    lib = SimpleNamespace(**{
        name + suffix: SimpleNamespace()
        for name in names
        for suffix in ("",) + (extra if name != GRAD2 else grad2)})
    wb._bind(lib)
    for name in names:
        for suffix in ("_bf16", "_bf16_gather"):
            if hasattr(lib, name + suffix):
                fn = getattr(lib, name + suffix)
                assert fn.argtypes == getattr(lib, name).argtypes
    assert len(getattr(lib, GRAD2).argtypes) == 14
    assert hasattr(lib, GRAD2 + "_bf16") == bool(grad2)
    assert not hasattr(lib, GRAD2 + "_bf16_gather")
    assert not hasattr(lib, names[0] + "_bf16_gather") or \
        "_bf16_gather" in extra


def test_reset_launches_clears_the_gather_counts():
    fns = (wb.warp_sample_bounded_forward, wb.warp_sample_bounded_grad_grid,
           wb.warp_sample_bounded_grad_grid_backward)
    for fn in fns:
        fn.launches = fn.gather_launches = 3
    wb.reset_launches()
    for fn in fns:
        assert fn.launches == fn.gather_launches == 0


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("grid_dtype", [torch.float32, torch.bfloat16])
def test_bf16_grad2_on_the_cpu_is_the_widened_plain_version_rounded(
        padding, grid_dtype):
    """On CPU tensors the bf16 K3-grad² is its plain version on the widened
    operands, gg rounded to bf16 and the grid's cotangent to the grid's
    type: the bits its bf16 kernel gives on the card."""
    n, c, h, w, r = 2, 3, 9, 13, 3
    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    img = torch.from_numpy(rng.random((n, c, h, w), np.float32)).to(bf)
    g = torch.from_numpy(rng.standard_normal((n, c, h, w),
                                             np.float32)).to(bf)
    v = torch.from_numpy(rng.standard_normal((n, h, w, 2), np.float32))
    grid = _grid("past", n, h, w, r, False, seed=4).to(grid_dtype)
    wb.reset_launches()
    gg, ggrid = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, r,
                                                          False, padding)
    want = wb.grid_sample_bounded_grad_grid_backward_ref(
        img.float(), grid.float(), g.float(), v, r, False, padding)
    assert gg.dtype == bf and ggrid.dtype == grid_dtype
    assert torch.equal(gg, want[0].to(bf))
    assert torch.equal(ggrid, want[1].to(grid_dtype))
    assert wb.warp_sample_bounded_grad_grid_backward.launches == 0
