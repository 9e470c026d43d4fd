"""The tile algebra of the bf16 SepConv kernels (csrc/sepconv.cu,
``sepconv_fwd_bf16_kernel`` and ``sepconv_grad_kernels_bf16_kernel``),
transcribed in plain PyTorch and held on the CPU against the JAX package's
TPU kernels in Pallas interpret mode and against the port's plain versions.

The kernels write the separable filter's sums as banded matrix products
for the tensor cores. For a row j of a 16x16 tile, the horizontal sums on
every staged input row r are

    U_j[x, (c, r)] = sum_m A_j[x, m] in_c(r, m),  A_j[x, m] = kh_(m-x)(j, x)

(A_j a 16 x 80 band: 16 + F - 1 = 66 columns of taps padded with zeros to
five mma k-steps of 16). The input rows r are absolute within the tile's
halo, so one staged B serves the R rows a warp stacks (K1 2, K2 1); a
warp's products cover the n8 tiles of rows [8 floor(j0 / 8), 8 ceil((j0 +
R + F - 1) / 8)), and a row outside a pixel's band meets a zero in the
fold:

    K1:  out_c(j, x) = sum_r kv_(r-j)(j, x) U_j[x, (c, r)]
    K2:  gkv_k(j, x) = sum_c g_c(j, x) U_j[x, (c, j + k)]

and for gkh the vertical product down a column x of the tile,

    V_x[y, (c, col)] = sum_r kv_(r-y)(y, x) in_c(r, col)   (K: 80 rows)
    gkh_l(y, x) = sum_c g_c(y, x) V_x[y, (c, x + l)].

Inputs are bf16-exact, so every product is exact in float32 and only the
order of the float32 sums differs from the references: tolerance 1e-4 of
the largest value plus 1e-5. On the card chip_smoke.py holds the kernels
themselves to the float32 kernels and to the plain versions.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meta_interpolation_tpu.ops import sepconv as jax_sc
from meta_interpolation_tpu_torch.ops import sepconv as sc

SOURCE = (Path(__file__).resolve().parents[1] / "meta_interpolation_tpu_torch"
          / "csrc" / "sepconv.cu")
T, K = 16, 80                # tile side, the band's K
R = {"forward": 2, "grad": 1}  # tile rows (columns) a warp
HALO_ROWS = {"forward": 72, "grad": 80}
REL, ABS = 1e-4, 1e-5
# (N, H, W, F): ragged tiles, two images, a short and an even filter
SHAPES = [(1, 37, 53, 51), (2, 21, 30, 51), (2, 21, 30, 5), (1, 37, 53, 50)]

pytestmark = pytest.mark.usefixtures("two_threads")


@pytest.fixture(scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _constants():
    text = SOURCE.read_text()

    def value(name):
        return int(re.search(rf"constexpr int {name} = (\w+);", text)
                   .group(1).replace("kK", str(K)))

    return {name: value(name) for name in (
        "kT", "kRFwd", "kRGrad", "kK", "kHaloRows1", "kHaloRows2")}


def test_transcription_uses_the_kernels_tile_shapes():
    assert _constants() == {"kT": T, "kRFwd": R["forward"],
                            "kRGrad": R["grad"], "kK": K,
                            "kHaloRows1": HALO_ROWS["forward"],
                            "kHaloRows2": HALO_ROWS["grad"]}


def _halo(inp_n, f, y0, x0, rows):
    """The staged halo of a tile, (C, rows, K): zero past the tile's halo
    (kT + F - 1 rows and columns) and past the input's edge."""
    c, hp, wp = inp_n.shape
    span = T + f - 1
    halo = inp_n.new_zeros((c, rows, K))
    r1, c1 = min(span, hp - y0), min(span, wp - x0)
    halo[:, :r1, :c1] = inp_n[:, y0:y0 + r1, x0:x0 + c1]
    return halo


def _map_tile(map_n, y0, x0):
    """A map's tile (F, T, T), zero outside the map."""
    f, h, w = map_n.shape
    tile = map_n.new_zeros((f, T, T))
    tile[:, :min(T, h - y0), :min(T, w - x0)] = map_n[:, y0:y0 + T,
                                                      x0:x0 + T]
    return tile


def _band(taps):
    """The band matrix (16, K) of 16 pixels' taps (16, F): A[p, m] = tap
    m - p of pixel p, 0 outside [0, F)."""
    p_count, f = taps.shape
    a = taps.new_zeros((p_count, K))
    for p in range(p_count):
        a[p, p:p + f] = taps[p]
    return a


def _n8_tiles(j0, r, f):
    """The first row (column) and the count of the staged rows (columns)
    the n8 tiles of a warp of r rows (columns) from j0 cover."""
    lo, end = j0 // 8, (j0 + r + f - 2) // 8 + 1
    return 8 * lo, 8 * (end - lo)


def _k_used(f):
    """The k-steps of 16 that the band needs (16 + F - 1 columns)."""
    return 16 * ((T + f - 1 + 15) // 16)


def _tiles(h, w):
    return [(y0, x0) for y0 in range(0, h, T) for x0 in range(0, w, T)]


def band_forward(inp, kv, kh):
    """K1 as the bf16 kernel computes it, tile by tile and warp by warp."""
    n, c, hp, wp = inp.shape
    f, h, w = kv.shape[1:]
    out = inp.new_zeros((n, c, h, w))
    ku = _k_used(f)
    for i in range(n):
        for y0, x0 in _tiles(h, w):
            halo = _halo(inp[i], f, y0, x0, HALO_ROWS["forward"])
            kvt, kht = _map_tile(kv[i], y0, x0), _map_tile(kh[i], y0, x0)
            tile = inp.new_zeros((c, T, T))
            r = R["forward"]
            for j0 in range(0, T, r):                    # a warp
                r0, nr = _n8_tiles(j0, r, f)
                b = halo[:, r0:r0 + nr, :ku]             # (C, N, K)
                for j in range(j0, j0 + r):
                    a = _band(kht[:, j, :].T)[:, :ku]    # (16 x, K)
                    u = torch.einsum("xm,crm->cxr", a, b)
                    fold = inp.new_zeros((T, nr))        # kv_(r-j)(j, x)
                    for e in range(nr):
                        k = r0 + e - j
                        if 0 <= k < f:
                            fold[:, e] = kvt[k, j, :]
                    tile[:, j, :] = (u * fold).sum(-1)
            hh, ww = min(T, h - y0), min(T, w - x0)
            out[i, :, y0:y0 + hh, x0:x0 + ww] = tile[:, :hh, :ww]
    return out


def band_grad_kernels(inp, g, kv, kh):
    """K2 as the bf16 kernel computes it: gkv from the horizontal products
    folded with g, gkh from the vertical ones."""
    n, c, hp, wp = inp.shape
    f, h, w = kv.shape[1:]
    gkv, gkh = torch.zeros_like(kv), torch.zeros_like(kh)
    ku = _k_used(f)
    for i in range(n):
        for y0, x0 in _tiles(h, w):
            halo = _halo(inp[i], f, y0, x0, HALO_ROWS["grad"])
            kvt, kht = _map_tile(kv[i], y0, x0), _map_tile(kh[i], y0, x0)
            gt = inp.new_zeros((c, T, T))
            gt[:, :min(T, h - y0), :min(T, w - x0)] = g[i, :, y0:y0 + T,
                                                        x0:x0 + T]
            gkv_t, gkh_t = inp.new_zeros((f, T, T)), inp.new_zeros((f, T, T))
            r = R["grad"]
            for j0 in range(0, T, r):                    # a warp
                r0, nr = _n8_tiles(j0, r, f)
                for j in range(j0, j0 + r):
                    # horizontal: row j, B^T = staged rows x columns
                    a = _band(kht[:, j, :].T)[:, :ku]
                    u = torch.einsum("xm,crm->cxr", a,
                                     halo[:, r0:r0 + nr, :ku])
                    s = (gt[:, j, :, None] * u).sum(0)   # (16 x, N)
                    for k in range(f):
                        gkv_t[k, j, :] = s[:, j + k - r0]
                    # vertical: column j, B = staged rows (k) x columns
                    a = _band(kvt[:, :, j].T)[:, :ku]    # (16 y, K)
                    v = torch.einsum("ym,cmn->cyn", a,
                                     halo[:, :ku, r0:r0 + nr])
                    s = (gt[:, :, j, None] * v).sum(0)   # (16 y, N)
                    for l in range(f):
                        gkh_t[l, :, j] = s[:, j + l - r0]
            hh, ww = min(T, h - y0), min(T, w - x0)
            gkv[i, :, y0:y0 + hh, x0:x0 + ww] = gkv_t[:, :hh, :ww]
            gkh[i, :, y0:y0 + hh, x0:x0 + ww] = gkh_t[:, :hh, :ww]
    return gkv, gkh


def _bf16_exact(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _data(n, h, w, f, seed):
    rs = np.random.RandomState(seed)
    inp = _bf16_exact(rs.rand(n, 3, h + f - 1, w + f - 1).astype(np.float32))
    kv, kh = (_bf16_exact(rs.randn(n, f, h, w).astype(np.float32))
              for _ in "vh")
    g = _bf16_exact(rs.randn(n, 3, h, w).astype(np.float32))
    return inp, g, kv, kh


def _jax(t):
    """NCHW / (N, F, H, W) torch → NHWC / (N, H, W, F) float32 jax."""
    return jnp.asarray(t.numpy().transpose(0, 2, 3, 1))


def _torch(x):
    return torch.from_numpy(np.array(x, np.float32).transpose(0, 3, 1, 2))


def _close(got, want, what):
    lim = REL * want.abs().max().item() + ABS
    err = (got - want).abs().max().item()
    assert err <= lim, f"{what}: max|diff| {err:.3e} > {lim:.3e}"


@pytest.mark.parametrize("n,h,w,f", SHAPES)
def test_band_forward_matches_the_tpu_kernel_and_the_plain_version(n, h, w,
                                                                   f):
    inp, _, kv, kh = _data(n, h, w, f, seed=h + w + f)
    got = band_forward(inp, kv, kh)
    want = _torch(jax_sc._pallas_forward(_jax(inp), _jax(kv), _jax(kh), f,
                                         interpret=True))
    _close(got, want, "against the interpret-mode TPU kernel")
    _close(got, sc.sepconv_ref(inp, kv, kh), "against sepconv_ref")


@pytest.mark.parametrize("n,h,w,f", SHAPES)
def test_band_grad_kernels_match_the_tpu_kernel_and_the_plain_version(
        n, h, w, f):
    inp, g, kv, kh = _data(n, h, w, f, seed=h + w + f + 1)
    got = band_grad_kernels(inp, g, kv, kh)
    want = jax_sc._pallas_grad_kernels(_jax(inp), _jax(g), _jax(kv),
                                       _jax(kh), f, interpret=True)
    ref = sc.grad_kernels_ref(inp, g, kv, kh)
    for part, a, b, c in zip(("gkv", "gkh"), got, want, ref):
        _close(a, _torch(b), f"{part} against the interpret-mode TPU kernel")
        _close(a, c, f"{part} against grad_kernels_ref")
