"""The port's flow projection (meta_interpolation_tpu_torch/ops/
flow_projection.py, ops/flow_projection_bounded.py) held against the JAX
package on the CPU.

On CPU tensors the K4 wrapper runs its plain version; the CUDA kernel it
stands for is held against the same plain version on the card by
chip_smoke.py. The kernel's algorithm (csrc/flow_projection.cu: the window
folded per axis into tile bit masks, per-row lists in halo order, the sweep
with the multiplicity folded in, halos in bands) is transcribed in numpy
below and held here bit for bit against a transcription of the earlier
design's window sweep, and within tolerance against the plain version and
the TPU kernel in interpret mode. Inputs come from a numpy seed; flows are
(N, H, W, 2) and depths (N, H, W, 1) in both packages.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import flow_projection as jax_fp
from meta_interpolation_tpu.ops.flow_projection_pallas import (
    flow_projection_bounded as pallas_bounded)
from meta_interpolation_tpu_torch.ops import flow_projection as fp
from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb


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


# K4's plain version against the TPU kernel in interpret mode: the limits
# of tests/test_dain_ops.py:193 (float32, another summation order)
K4_ATOL, K4_RTOL = 2e-5, 1e-5
# the exact scatter: float32 sums of at most a few contributions a cell
ATOL, RTOL = 1e-5, 1e-5
R = 8
# the kernel's tile: warp a owns tile row a, lane j tile column j
TILE_Y, TILE_X = 32, 32


def _inputs(n, h, w, span, seed):
    rs = np.random.RandomState(seed)
    flow = (rs.rand(n, h, w, 2) * 2 * span - span).astype(np.float32)
    depth = (rs.rand(n, h, w, 1) + 0.3).astype(np.float32)
    return flow, depth


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(scope="module")
def jax_exact():
    return jax.jit(jax_fp.flow_projection, static_argnames="fill_hole")


@pytest.mark.parametrize("r, span", [(R, 6.0), (R, 12.0), (0, 0.75),
                                     (0, 3.0), (1, 1.5), (1, 4.0)],
                         ids=["within_R", "past_R", "R0_small", "R0_past",
                              "R1_small", "R1_past"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_plain_k4_matches_pallas_interpret(r, span, with_depth):
    """(2, 16, 32), flows in [−span, span]: past R the kernel drops the far
    sources, and the plain version must drop the same ones (at R = 0 the
    window [0, 1] drops every source whose floor moves it up or left)."""
    seed = int(span) + with_depth + (0 if r == R else 100 + 10 * r)
    flow, depth = _inputs(2, 16, 32, span, seed=seed)
    depth = depth if with_depth else None
    want_proj, want_cnt = pallas_bounded(_j(flow), _j(depth),
                                         max_displacement=r, interpret=True)
    got_proj, got_cnt = fpb.flow_projection_bounded(_t(flow), _t(depth), r)
    np.testing.assert_allclose(got_proj.numpy(), np.asarray(want_proj),
                               atol=K4_ATOL, rtol=K4_RTOL)
    np.testing.assert_allclose(got_cnt.numpy(), np.asarray(want_cnt),
                               atol=K4_ATOL, rtol=K4_RTOL)
    np.testing.assert_array_equal(got_cnt.numpy() > 0,
                                  np.asarray(want_cnt) > 0)
    if span > r + 1:
        # the bound really dropped sources: the exact scatter differs
        exact, _ = fpb.project_ref(_t(flow), _t(depth))
        assert float((exact - got_proj).abs().max()) > 1e-3


@pytest.mark.parametrize("with_depth", [True, False])
@pytest.mark.parametrize("fill_hole", [False, True])
def test_exact_matches_jax(jax_exact, with_depth, fill_hole):
    """Ragged (2, 13, 19), flows past the frame so that some sources land
    outside and leave holes."""
    flow, depth = _inputs(2, 13, 19, 5.0, seed=3)
    depth = depth if with_depth else None
    want = jax_exact(_j(flow), _j(depth), fill_hole=fill_hole)
    got = fp.flow_projection(_t(flow), _t(depth), fill_hole=fill_hole)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_fill_holes_equals_jax_scan():
    """Bit for bit, on random hole patterns including all-hole rows and
    columns and fully valid frames, as tests/test_dain_ops.py pins the
    JAX package's two fills."""
    rng = np.random.RandomState(0)
    for density in (0.0, 0.3, 0.97, 1.0):
        cnt = ((rng.rand(2, 13, 17) < density)
               * (1 + rng.rand(2, 13, 17))).astype(np.float32)
        out = np.where(cnt[..., None] > 0, rng.randn(2, 13, 17, 2),
                       0.0).astype(np.float32)
        want = jax_fp._fill_holes_scan(jnp.asarray(out), jnp.asarray(cnt))
        got = fp.fill_holes(torch.from_numpy(out), torch.from_numpy(cnt))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("proj_range", [None, R])
def test_gradient_matches_jax(proj_range):
    """d/d(flow, depth) of Σ g·flow_projection(fill_hole=True): the exact
    scatter's VJP on both paths (the fill carries no gradient). The JAX
    package takes its scatter on the CPU either way; its bounded path's
    custom VJP is that same scatter VJP."""
    flow, depth = _inputs(1, 12, 16, 4.0, seed=5)
    g = np.random.RandomState(6).randn(1, 12, 16, 2).astype(np.float32)

    def jax_loss(f, d):
        return jnp.sum(jax_fp.flow_projection(f, d, fill_hole=True)
                       * jnp.asarray(g))

    want = jax.grad(jax_loss, argnums=(0, 1))(_j(flow), _j(depth))
    f_t = torch.from_numpy(flow).requires_grad_()
    d_t = torch.from_numpy(depth).requires_grad_()
    out = fp.flow_projection(f_t, d_t, fill_hole=True, proj_range=proj_range)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((f_t.grad, d_t.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=1e-4)


def test_cpu_dispatch_takes_the_plain_version():
    """proj_range on a CPU tensor runs K4's plain version (window mask
    included), never the exact scatter, and counts no launch."""
    flow, depth = _inputs(1, 16, 24, 12.0, seed=7)
    fpb.reset_launches()
    got = fp.flow_projection(_t(flow), _t(depth), proj_range=R)
    want, _ = fpb.project_ref(_t(flow), _t(depth), R)
    exact, _ = fpb.project_ref(_t(flow), _t(depth))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert float((exact - got).abs().max()) > 1e-3
    assert fpb.flow_projection_bounded.launches == 0



# ---------------------------------------------------------------------------
# csrc/flow_projection.cu's algorithm, transcribed
# ---------------------------------------------------------------------------

def _flow(kind, n, h, w, span, seed):
    """Flows of the kernel's edge cases, as chip_smoke.py's proj_flow makes
    them: "uniform" in [−span, span]; "integer" offsets with landings
    clipped to [−1, H−1] × [−1, W−1] (many exactly on the bottom and right
    edges, some outside); "one_cell": every source onto the centre cell;
    "one_row": every source onto row 12 in columns 0-31."""
    rs = np.random.RandomState(seed)
    ys = np.arange(h, dtype=np.float32)[None, :, None] + np.zeros((n, h, w),
                                                                np.float32)
    xs = np.arange(w, dtype=np.float32)[None, None, :] + np.zeros((n, h, w),
                                                                np.float32)
    if kind == "uniform":
        fx, fy = (rs.rand(2, n, h, w) * 2 * span - span).astype(np.float32)
    elif kind == "integer":
        k = rs.randint(-span, span + 1, (2, n, h, w)).astype(np.float32)
        fx = np.clip(xs + k[0], -1, w - 1) - xs
        fy = np.clip(ys + k[1], -1, h - 1) - ys
    elif kind == "one_cell":
        fx, fy = w // 2 - xs, h // 2 - ys
    elif kind == "one_row":
        fx, fy = np.clip(xs, 0, 31) - xs, 12 - ys
    else:
        raise ValueError(kind)
    depth = (rs.rand(n, h, w, 1) + 0.3).astype(np.float32)
    return np.stack([fx, fy], -1).astype(np.float32), depth


def _landings(flow, depth, r, sy, sx):
    """The kernel's per-source decisions for sources (sy, sx) of image 0 of
    (1, H, W, 2) ``flow`` (outside the image: a zero flow, as the zero-fill
    copy gives): valid, t, b, l, r and the three contributions (−fx·wv,
    −fy·wv, wv) in float32, before any multiplicity."""
    _, h, w, _ = flow.shape
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    f = np.zeros(sy.shape + (2,), np.float32)
    f[inside] = flow[0, sy[inside], sx[inside]]
    wv = np.ones(sy.shape, np.float32)
    if depth is not None:
        wv = np.zeros(sy.shape, np.float32)
        wv[inside] = depth[0, sy[inside], sx[inside], 0]
    x2 = sx.astype(np.float32) + f[..., 0]
    y2 = sy.astype(np.float32) + f[..., 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    t = np.floor(np.where(valid, y2, 0)).astype(np.int64)
    left = np.floor(np.where(valid, x2, 0)).astype(np.int64)
    bt, rt = np.minimum(t + 1, h - 1), np.minimum(left + 1, w - 1)
    contrib = np.stack([-f[..., 0] * wv, -f[..., 1] * wv, wv], -1)
    return valid, t, bt, left, rt, contrib


def _design(flow, depth, r, band=None):
    """csrc/flow_projection.cu in numpy → (proj, cnt, list lengths). For
    each 32 × 32 tile and band of halo rows: stage (per-axis window and
    tile tests as bit masks, multiplicity folded into the contributions),
    a list a tile row of the halo indices whose row mask holds it, in halo
    order, and the sweep: each lane adds, in list order, the entries whose
    column mask holds it."""
    n, h, w, _ = flow.shape
    span, rows = TILE_X + 2 * r + 1, TILE_Y + 2 * r + 1
    band = rows if band is None else band
    cap = min(band, 2 * r + 2) * span
    acc = np.zeros((n, h, w, 3), np.float32)
    lengths = []

    def bits(v, s, origin, extent):
        keep = ((v - s >= -r) & (v - s <= r + 1) & (v - origin >= 0)
                & (v - origin < extent))
        return np.where(keep, np.left_shift(1, np.clip(v - origin, 0, 31)),
                        0)

    for b in range(n):
        for ty0 in range(0, h, TILE_Y):
            for tx0 in range(0, w, TILE_X):
                tile = np.zeros((TILE_Y, TILE_X, 3), np.float32)
                for r0 in range(0, rows, band):
                    sy, sx = np.meshgrid(
                        ty0 - r - 1 + r0 + np.arange(min(band, rows - r0)),
                        tx0 - r - 1 + np.arange(span), indexing="ij")
                    valid, t, bt, left, rt, c = _landings(
                        flow[b:b + 1], None if depth is None else
                        depth[b:b + 1], r, sy, sx)
                    cols = np.where(valid, bits(left, sx, tx0, TILE_X)
                                    | bits(rt, sx, tx0, TILE_X), 0)
                    rows_hit = np.where(cols != 0, bits(t, sy, ty0, TILE_Y)
                                        | bits(bt, sy, ty0, TILE_Y), 0)
                    mult = (np.where(t == bt, 2, 1)
                            * np.where(left == rt, 2, 1)).astype(np.float32)
                    c = (c * mult[..., None]).reshape(-1, 3)
                    cols, rows_hit = cols.reshape(-1), rows_hit.reshape(-1)
                    lane = np.arange(TILE_X)
                    for a in range(min(TILE_Y, h - ty0)):
                        entries = np.flatnonzero((rows_hit >> a) & 1)
                        assert len(entries) <= cap
                        lengths.append(len(entries))
                        hit = (cols[entries][:, None] >> lane) & 1 == 1
                        terms = np.where(hit[..., None], c[entries][:, None],
                                         np.float32(0))
                        # sequential float32 adds in list order
                        tile[a] = np.add.accumulate(
                            np.concatenate([tile[a][None], terms]), axis=0,
                            dtype=np.float32)[-1]
                ye, xe = min(TILE_Y, h - ty0), min(TILE_X, w - tx0)
                acc[b, ty0:ty0 + ye, tx0:tx0 + xe] = tile[:ye, :xe]
    cnt = acc[..., 2]
    den = np.maximum(cnt, np.float32(1e-12))[..., None]
    proj = np.where(cnt[..., None] > 0, acc[..., :2] / den, acc[..., :2])
    return proj, cnt, lengths


def _window_sweep(flow, depth, r):
    """The earlier design in numpy: each target sums over the sources of
    its (2R+2)² window in row-major order, fmaf(m, c, acc) with m the
    multiplicity, in float32 → (proj, cnt)."""
    n, h, w, _ = flow.shape
    acc = np.zeros((n, h, w, 3), np.float32)
    ty, tx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for b in range(n):
        for dy in range(2 * r + 2):
            for dx in range(2 * r + 2):
                sy, sx = ty - r - 1 + dy, tx - r - 1 + dx
                valid, t, bt, left, rt, c = _landings(
                    flow[b:b + 1], None if depth is None else depth[b:b + 1],
                    r, sy, sx)
                m = (((t == ty).astype(np.int64) + (bt == ty))
                     * ((left == tx).astype(np.int64) + (rt == tx)) * valid)
                # m·c is exact (m is 0, 1, 2 or 4): fmaf rounds only the add
                acc[b] = np.where((m > 0)[..., None],
                                  acc[b] + m[..., None].astype(np.float32) * c,
                                  acc[b])
    cnt = acc[..., 2]
    den = np.maximum(cnt, np.float32(1e-12))[..., None]
    proj = np.where(cnt[..., None] > 0, acc[..., :2] / den, acc[..., :2])
    return proj, cnt


# (kind, N, H, W, R, span, halo rows a band or None): the kernel's edge
# cases; H a multiple of 8 where the TPU kernel is held to them too
DESIGN_CASES = {
    "R0": ("uniform", 2, 37, 53, 0, 2, None),
    "R1": ("uniform", 2, 37, 53, 1, 3, None),
    "past_R": ("uniform", 2, 40, 53, R, 11, None),
    "integer_and_edges": ("integer", 2, 37, 53, R, R + 1, None),
    "one_cell": ("one_cell", 1, 37, 53, R, 0, None),
    "one_row": ("one_row", 1, 40, 53, R, 0, None),
    "ragged_n2": ("uniform", 2, 24, 70, R, R, None),
    "bands": ("uniform", 1, 40, 45, 6, 7, 9),
}


@pytest.mark.parametrize("case", DESIGN_CASES)
def test_design_equals_earlier_window_sweep_bitwise(case):
    """The list design adds the earlier sweep's terms in its order, so both
    transcriptions agree bit for bit, as chip_smoke.py holds the two CUDA
    kernels to torch.equal."""
    kind, n, h, w, r, span, band = DESIGN_CASES[case]
    flow, depth = _flow(kind, n, h, w, span, seed=len(case))
    for d in (depth, None):
        proj, cnt, _ = _design(flow, d, r, band)
        want_proj, want_cnt = _window_sweep(flow, d, r)
        np.testing.assert_array_equal(cnt, want_cnt)
        np.testing.assert_array_equal(proj, want_proj)


@pytest.mark.parametrize("case", DESIGN_CASES)
def test_design_matches_plain_and_pallas_interpret(case):
    """Against the plain version (and, where H % 8 == 0, the TPU kernel in
    interpret mode) within the limits of test_plain_k4_matches_pallas_
    interpret, with identical hole sets."""
    kind, n, h, w, r, span, band = DESIGN_CASES[case]
    flow, depth = _flow(kind, n, h, w, span, seed=len(case))
    proj, cnt, _ = _design(flow, depth, r, band)
    wants = [fpb.project_ref(_t(flow), _t(depth), r)]
    if h % 8 == 0:
        wants.append(pallas_bounded(_j(flow), _j(depth), max_displacement=r,
                                    interpret=True))
    for want_proj, want_cnt in wants:
        np.testing.assert_allclose(proj, np.asarray(want_proj), atol=K4_ATOL,
                                   rtol=K4_RTOL)
        np.testing.assert_allclose(cnt, np.asarray(want_cnt), atol=K4_ATOL,
                                   rtol=K4_RTOL)
        np.testing.assert_array_equal(cnt > 0, np.asarray(want_cnt) > 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind, span", [("uniform", R), ("one_row", 0)])
def test_chip_smoke_list_lengths_are_the_designs(kind, span):
    """chip_smoke.py's count of a warp's list (mean, largest) is that of
    the transcription; the one-row flow fills a row's list to 18 × 40 of
    its 18 × 49 sources (the 9 columns left of the image hold none)."""
    flow, _ = _flow(kind, 1, 40, 53, span, seed=1)
    _, _, lengths = _design(flow, None, R)
    mean, top = _chip_smoke().k4_list_lengths(torch, torch.from_numpy(flow),
                                              R)
    assert top == max(lengths)
    assert mean == pytest.approx(np.mean(lengths), rel=1e-6)
    if kind == "one_row":
        assert top == 18 * 40
