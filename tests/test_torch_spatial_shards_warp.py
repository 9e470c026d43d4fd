"""The port's exact row-sharded evaluation (``--spatial_shards``) of the
warp models, RRIN, SuperSloMo and VoxelFlow, held on the CPU against the
whole frame, against the port in one process and (RRIN and VoxelFlow)
against the JAX package unsharded.

The bounded sampler on a band (``ops/warp_bounded.py``, ``row0``): the
plain K3 and K3-grad of a band's grid are the whole-frame call's same
rows bit for bit, at each padding mode and align_corners, R = 4 and 8,
for the first, a middle and the last band; the warps of ``ops/warp.py``
likewise; the bf16 kernels refuse a band (K3-grad²'s band rows are held in
tests/test_torch_warp_double_backward.py, training on bands in
tests/test_torch_band_train.py).

Four gloo ranks are spawned once for the file (``parallel/launch.spawn``)
and run every multi-rank case (:func:`_rank_cases`) on three meshes: 1x4
(4 bands), 2x2 (2 tasks of 2 bands) and 1x2 over ranks 0 and 1, then the
port in one process, each run on one rank; the parent computes the JAX
references while they run, and the tests below read what both saved.

Tolerances: the align_corners=False upsample and ``conv_as_input`` on
bands against the whole frame's, in float64, 1e-6 of the largest value of
the output and of each gradient; the full-width models on 4 bands in
float64, bounded and exact, 1e-10 of the prediction's largest value and
of the support gradient's norm; against the port in one process, where
only the order of the sums differs, the prediction within 1e-5 of the
larger of its and the frames' largest value and the loss, PSNR and SSIM
1e-6 relative; against JAX, the prediction 1e-4 (absolute and relative)
and the PSNR 1e-3 dB.
"""
import contextlib
import pathlib
import shutil
import threading

import numpy as np
import pytest
import torch

from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models import (
    layers, rrin, superslomo, voxelflow)
from meta_interpolation_tpu_torch.ops import warp
from meta_interpolation_tpu_torch.ops import warp_bounded as wb
from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
from meta_interpolation_tpu_torch.parallel import spatial
from meta_interpolation_tpu_torch.parallel.launch import spawn
from test_torch_spatial_shards import banded_summary

RANKS = 4
R = 8
# the presets (scripts/run_rrin.sh: Adam, LSLR with 0 training steps,
# 1*L1; run_superslomo.sh: Adam, Meta-SGD, 1*Super; run_voxelflow.sh:
# Adam, Meta-SGD, 1*MSE), one evaluation step. RRIN pads a 32-row crop to
# a 128-row grid (4 bands of 32, Flow_L's 4 pools to 2 rows), VoxelFlow to
# 64 (4 bands of 16), SuperSloMo a 64-row crop to 64 (2 bands of 32)
PRESETS = {
    "rrin": dict(model="rrin", optimizer="Adam", inner_lr=1e-5, loss="1*L1",
                 number_of_training_steps_per_iter=0,
                 number_of_evaluation_steps_per_iter=1, crop_size=32),
    "superslomo": dict(model="superslomo", loss="1*Super", optimizer="Adam",
                       metasgd=True, inner_lr=1e-5,
                       number_of_training_steps_per_iter=1,
                       number_of_evaluation_steps_per_iter=1, crop_size=64),
    "voxelflow": dict(model="voxelflow", loss="1*MSE", optimizer="Adam",
                      metasgd=True, inner_lr=1e-5,
                      number_of_training_steps_per_iter=1,
                      number_of_evaluation_steps_per_iter=1, crop_size=32),
}
# (model, mode, mesh, --fast_warp_range) of every sharded run: a 1xS mesh
# runs one clip, 2x2 two (a clip a task group)
RUNS = [("rrin", "val", "1x4", R), ("rrin", "val", "1x2", 0),
        ("rrin", "test", "2x2", R), ("superslomo", "val", "1x2", R),
        ("superslomo", "test", "2x2", 0), ("voxelflow", "val", "1x4", R),
        ("voxelflow", "val", "2x2", 0), ("voxelflow", "test", "1x4", R)]
# the runs held to JAX unsharded (SuperSloMo is held to the port in one
# process; tests/test_torch_superslomo_episode.py holds that to JAX), the
# exact RRIN first: op by op, the bounded one reuses its compiled
# primitives
JAX_RUNS = [("rrin", "val", "1x2", 0), ("rrin", "val", "1x4", R),
            ("voxelflow", "val", "1x4", R)]
JAX_PRED_TOL, JAX_PSNR_TOL = 1e-4, 1e-3
SAME_PRED_RTOL, SAME_LOSS_RTOL = 1e-5, 1e-6
OP_RTOL = 1e-6
EXACT64_RTOL = 1e-10
# the full-width models in float64 on 4 bands: (model, syn_type, R); the
# frame's rows pad to 128 (RRIN, SuperSloMo) or 64 (VoxelFlow)
EXACT64 = [("rrin", None, R), ("rrin", None, 0), ("superslomo", None, R),
           ("superslomo", None, 0), ("voxelflow", "inter", R),
           ("voxelflow", "inter", 0), ("voxelflow", "extra", 0)]
EXACT64_HW = {"rrin": (32, 32), "superslomo": (96, 32), "voxelflow": (32, 32)}
# the row-aware ops on bands of 4 rows and (the *_1row ones) of 1: the
# align_corners=False upsample, and conv_as_input with a 5x5 conv (3x3 on
# 1-row bands)
OPS = ["upsample", "conv_as_input", "upsample_1row", "conv_as_input_1row"]
SHARDS = {"1x4": 4, "2x2": 2}
# the plain bounded sampler on bands: an (N, C, H, W) image, its bands
BAND_SHAPE = (2, 3, 24, 20)
BANDS = {"first": (0, 6), "middle": (12, 6), "last": (18, 6),
         "one_row": (7, 1)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the bounded sampler and the warps on a band -------------------------

def _sampler_inputs(seed=0, dtype=torch.float32):
    """An image, a grid whose samples reach past R and off every edge, and
    an output gradient."""
    gen = torch.Generator().manual_seed(seed)
    n, c, h, w = BAND_SHAPE
    img = torch.rand(BAND_SHAPE, generator=gen, dtype=dtype)
    grid = (torch.rand(n, h, w, 2, generator=gen, dtype=dtype) * 2.6 - 1.3)
    g = torch.randn(BAND_SHAPE, generator=gen, dtype=dtype)
    return img, grid, g


@pytest.mark.parametrize("band", list(BANDS))
@pytest.mark.parametrize("r", [4, R])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding", list(wb.PADDING_MODES))
def test_bounded_sampler_band_is_the_whole_frames_rows(padding,
                                                       align_corners, r,
                                                       band):
    """K3 and K3-grad's plain versions, through their wrappers, on a band's
    grid with ``row0``: bit for bit the whole-frame call's rows."""
    img, grid, g = _sampler_inputs()
    row0, rows = BANDS[band]
    opts = (r, align_corners, padding)
    whole = wb.warp_sample_bounded_forward(img, grid, *opts)
    whole_g = wb.warp_sample_bounded_grad_grid(img, grid, g, *opts)
    sl = slice(row0, row0 + rows)
    got = wb.warp_sample_bounded_forward(img, grid[:, sl], *opts, row0=row0)
    got_g = wb.warp_sample_bounded_grad_grid(img, grid[:, sl], g[:, :, sl],
                                             *opts, row0=row0)
    assert got.shape == (2, 3, rows, 20)
    assert torch.equal(got, whole[:, :, sl])
    assert torch.equal(got_g, whole_g[:, sl])


def test_bounded_sampler_bands_sum_to_the_image_gradient():
    """The image gradient of a band's sample (the plain one, autograd
    through the sweep) lands in the whole image; the bands' add up to the
    whole frame's."""
    img, grid, g = _sampler_inputs(1, torch.float64)
    leaf = img.clone().requires_grad_()
    (warp.grid_sample_bounded(leaf, grid, R) * g).sum().backward()
    total = torch.zeros_like(img)
    for row0, rows in ((0, 6), (6, 6), (12, 6), (18, 6)):
        band = img.clone().requires_grad_()
        sl = slice(row0, row0 + rows)
        out = warp.grid_sample_bounded(band, grid[:, sl], R, row0=row0)
        (out * g[:, :, sl]).sum().backward()
        total += band.grad
    torch.testing.assert_close(total, leaf.grad, rtol=0, atol=1e-12)


def test_band_calls_without_a_band_form_raise():
    """The bf16 K3, K3-grad and K3-grad² raise on a band rather than
    sample the wrong rows; the float32 K3-grad² (through the second
    derivative of a band's sample) takes it."""
    img, grid, g = _sampler_inputs()
    band, gb = grid[:, 6:12], g[:, :, 6:12]
    with pytest.raises(NotImplementedError, match="bfloat16"):
        wb.warp_sample_bounded_forward(img.bfloat16(), band, R, row0=6)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        wb.warp_sample_bounded_grad_grid(img.bfloat16(), band, gb.bfloat16(),
                                         R, row0=6)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        wb.warp_sample_bounded_grad_grid_backward(
            img.bfloat16(), band, gb.bfloat16(), torch.ones_like(band), R,
            row0=6)
    leaf = band.clone().requires_grad_()
    out = warp.grid_sample_bounded(img, leaf, R, row0=6)
    ggrid, = torch.autograd.grad((out * gb).sum(), leaf, create_graph=True)
    second, = torch.autograd.grad(ggrid.sum(), leaf)
    assert second.shape == band.shape and bool(second.abs().sum() > 0)


def _warp_call(kind, img0, img1, flow, mask, wr, row0):
    if kind == "rrin":
        return warp.backward_warp_rrin(img0, flow, warp_range=wr, row0=row0)
    if kind.startswith("backward_warp"):
        return warp.backward_warp(img0, flow, align_corners=kind.endswith(
            "align"), warp_range=wr, row0=row0)
    return warp.voxelflow_sample(img0, img1, flow / 8.0, mask,
                                 warp_range=wr, row0=row0)


@pytest.mark.parametrize("wr", [R, 0])
@pytest.mark.parametrize("kind", ["rrin", "backward_warp",
                                  "backward_warp_align", "voxelflow"])
def test_warps_on_a_band_are_the_whole_frames_rows(kind, wr):
    """A band's flow (and mask) from ``row0`` samples the whole frames at
    the band's global rows, bounded and exact: the whole-frame warp's
    rows bit for bit; FlowStats measures from the global rows."""
    gen = torch.Generator().manual_seed(3)
    img0, img1 = (torch.rand(1, 3, 24, 20, generator=gen) for _ in range(2))
    flow = torch.randn(1, 24, 20, 2, generator=gen) * 5
    mask = torch.rand(1, 1, 24, 20, generator=gen) * 2 - 1
    whole = _warp_call(kind, img0, img1, flow, mask, wr, 0)
    for row0 in (0, 8, 16):
        sl = slice(row0, row0 + 8)
        got = _warp_call(kind, img0, img1, flow[:, sl], mask[:, :, sl], wr,
                         row0)
        assert torch.equal(got, whole[:, :, sl]), row0
    if not wr:
        with warp.FlowStats(R) as want:
            _warp_call(kind, img0, img1, flow, mask, wr, 0)
        with warp.FlowStats(R) as got:
            for row0 in (0, 8, 16):
                sl = slice(row0, row0 + 8)
                _warp_call(kind, img0, img1, flow[:, sl], mask[:, :, sl],
                           wr, row0)
        assert (got.n_beyond, got.n_total, got.max_disp) == (
            want.n_beyond, want.n_total, want.max_disp)


def test_row_bands_follow_each_grid():
    """Each model's grid splits into bands its pools halve evenly: RRIN's
    ×128 grid into bands of 16·k rows, SuperSloMo's ×64 into 32·k,
    VoxelFlow's ×64 into 8·k; 720 rows pad to 768 in each."""
    gen = torch.Generator().manual_seed(0)
    models = {"rrin": rrin.RRIN(gen), "superslomo": superslomo.SuperSloMo(
        gen), "voxelflow": voxelflow.VoxelFlow(gen)}
    assert [models["rrin"].row_bands(720, s) for s in (2, 4, 8, 16, 32)] == [
        True, True, True, True, False]
    assert [models["superslomo"].row_bands(h, 4) for h in (64, 96, 720)] == [
        False, True, True]
    assert [models["voxelflow"].row_bands(h, s) for h, s in (
        (32, 4), (32, 8), (64, 16), (720, 2))] == [True, True, False, True]
    assert models["rrin"].grid_rows(720) == 768
    assert models["voxelflow"].grid_rows(720) == 768
    assert models["superslomo"].grid_rows(256) == 256


# -- the ranks ------------------------------------------------------------

class _ConvAsInput(torch.nn.Module):
    """A bias-free conv through ``layers.conv_as_input``, as VoxelFlow's."""

    def __init__(self, ch, k, gen):
        super().__init__()
        self.conv = layers.normal_init_(torch.nn.Conv2d(
            ch, 5, k, padding=k // 2, bias=False), 0.1, gen)

    def forward(self, x):
        return layers.conv_as_input(self.conv, x)


def _op_module(name, ch):
    gen = torch.Generator().manual_seed(OPS.index(name))
    if name.startswith("upsample"):
        return layers.Upsample(2, align_corners=False)
    return _ConvAsInput(ch, 3 if name.endswith("1row") else 5, gen)


def _op_case(name, shard, x, g):
    """The op on the whole (float64) frame and on this rank's band: the
    outputs (the bands' gathered), and the gradients of Σ out·g in the
    frame and the op's parameters (the bands' summed over the ranks)."""
    module = _op_module(name, x.shape[1]).double()
    params = list(module.parameters())
    whole = x.clone().requires_grad_()
    out = module(whole)
    grads = torch.autograd.grad((out * g).sum(), [whole] + params)
    band = x.clone().requires_grad_()
    with spatial.row_shard(shard):
        got = spatial.gather_band(module(spatial.band(band)))
    got_grads = spatial.all_reduce_grads(
        torch.autograd.grad((got * g).sum(), [band] + params), shard)
    return {"want": (out.detach(), grads), "got": (got.detach(), got_grads)}


def _net(model, syn_type, wr):
    gen = torch.Generator().manual_seed(0)
    kwargs = {"warp_range": wr or None}
    if syn_type:
        kwargs["syn_type"] = syn_type
    return {"rrin": rrin.RRIN, "superslomo": superslomo.SuperSloMo,
            "voxelflow": voxelflow.VoxelFlow}[model](gen, **kwargs).double()


def _exact64(case, shard, frames, whole):
    """A full-width model in float64 on this rank's band (and, where
    ``whole``, on the whole frame): the prediction and the gradient in
    every weight of its L1 loss, SuperSloMo's plus a term of every aux
    tensor (the bands' gradients summed over the ranks), as
    ``banded_summary``."""
    net = _net(*case)
    params = list(net.parameters())
    f0, f1, target = frames

    def run(context):
        with context:
            pred = net(f0, f1)
        loss = 0.0
        if isinstance(pred, tuple):
            pred, aux = pred
            loss = sum(0.1 * t.abs().mean() for ts in aux.values()
                       for t in ts)
        loss = loss + (pred - target).abs().mean()
        return pred.detach(), torch.autograd.grad(loss, params)
    pred, grads = run(spatial.row_shard(shard))
    return banded_summary(pred, spatial.all_reduce_grads(grads, shard),
                          run(contextlib.nullcontext()) if whole else None)


def _cfg(model, mode, wr, **kw):
    return Config(**PRESETS[model], mode=mode, fast_warp_range=wr,
                  device="cpu", **kw)


def _system(run, mesh, trees):
    model, mode, _, wr = run
    system = SceneAdaptiveInterpolation(
        _cfg(model, mode, wr, spatial_shards=mesh.spatial if mesh else 1),
        mesh=mesh)
    if model in trees:
        bridge.load_jax_meta_params(system, trees[model])
    return system


def _clips(run, frames):
    """The run's clips: one on a 1xS mesh, two on 2x2."""
    return frames[run[0]][:2 if run[2] == "2x2" else 1]


def _run(system, mode, frames):
    if mode == "val":
        losses, preds = system.run_validation_iter(frames)
        return {"losses": losses, "preds": preds}
    return {"preds": system.run_test_iter(frames[:, :4])}


def _rank_cases(rank, work):
    """Every multi-rank case, in one of the spawned ranks; what it
    computes is saved to ``work/rank<rank>.pt`` for the tests."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    work = pathlib.Path(work)
    mesh_lib.init_distributed("cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    meshes = {"1x4": mesh_lib.make_mesh("1x4"),
              "2x2": mesh_lib.make_mesh("2x2"),
              "1x2": mesh_lib.make_mesh("1x2", ranks=[0, 1])}
    # every bounded sample's (image rows, grid rows, row0)
    samples = []
    real_k3 = wb.warp_sample_bounded_forward

    def recorded(img, grid, r, align_corners=False, padding_mode="zeros",
                 row0=0):
        samples.append((img.shape[2], grid.shape[1], row0))
        return real_k3(img, grid, r, align_corners, padding_mode, row0)
    wb.warp_sample_bounded_forward = recorded
    out = {"ops": {}, "exact64": {}, "runs": {}}
    for shape, count in SHARDS.items():
        shard = spatial.RowShard.of(meshes[shape])
        out["ops"][shape] = {}
        for name in OPS:
            x, grads = inputs["ops"][count][
                "1row" if name.endswith("1row") else "band"]
            out["ops"][shape][name] = _op_case(
                name, shard, x, grads["up" if name.startswith("up")
                                      else "conv"])
    shard = spatial.RowShard.of(meshes["1x4"])
    for i, case in enumerate(EXACT64):
        # the whole frame once, on one rank a case
        out["exact64"][case] = _exact64(case, shard,
                                        inputs["exact64"][case[0]],
                                        whole=i % RANKS == rank)
    for run in RUNS:
        mesh = meshes[run[2]]
        if mesh is None:
            continue
        samples.clear()
        res = _run(_system(run, mesh, inputs["trees"]), run[1],
                   _clips(run, inputs["frames"]))
        out["runs"][run] = {**res, "samples": sorted(set(samples)),
                            "index": mesh.spatial_index}
    # the port in one process, one rank a run
    out["one"] = {run: _run(_system(run, None, inputs["trees"]), run[1],
                            _clips(run, inputs["frames"]))
                  for i, run in enumerate(RUNS) if i % RANKS == rank}
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _jax_refs(jax_systems, frames):
    """The JAX package's validation of RRIN (bounded and exact) and
    VoxelFlow (bounded) unsharded, op by op, the bounded sweep jitted."""
    from test_torch_warp_train import jitted_sweep
    refs = {}
    for run in JAX_RUNS:
        jsys = jax_systems[(run[0], run[3])]
        with jitted_sweep(jsys):
            losses, preds = jsys.run_validation_iter(_clips(run, frames))
        refs[run] = {"losses": losses,
                     "preds": np.asarray(preds).transpose(0, 3, 1, 2)}
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX systems' weights, then the ranks spawned once (in a thread)
    while the JAX references run here; the ranks' saved results beside
    them. The work directory is removed after the file's tests."""
    import jax

    from meta_interpolation_tpu.config import Config as JaxConfig
    from meta_interpolation_tpu.meta.system import (
        SceneAdaptiveInterpolation as JaxSystem)
    rs = np.random.RandomState(0)
    frames = {}
    for model, cfg in PRESETS.items():
        hw = (cfg["crop_size"],) * 2
        data = SyntheticSeptuplet(model=model, mode="val", size=hw)
        frames[model] = np.stack([np.asarray(data[i][0]) for i in (0, 1)])
    ops = {}
    for count in SHARDS.values():
        ops[count] = {}
        for kind, rows in (("band", 4 * count), ("1row", count)):
            shapes = {"up": (1, 4, rows * 2, 12), "conv": (1, 5, rows, 6)}
            ops[count][kind] = (
                torch.from_numpy(rs.randn(1, 4, rows, 6)),
                {k: torch.from_numpy(rs.randn(*v))
                 for k, v in shapes.items()})
    exact64 = {model: tuple(torch.from_numpy(rs.rand(1, 3, *hw))
                            for _ in range(3))
               for model, hw in EXACT64_HW.items()}
    jax_systems = {(run[0], run[3]): JaxSystem(JaxConfig(
        **PRESETS[run[0]], mode="val", fast_warp_range=run[3],
        jit_episode=False)) for run in JAX_RUNS}
    # one set of weights a model, the bounded system's
    jax_systems[("rrin", 0)].meta_params = jax_systems[("rrin", R)].meta_params
    trees = {model: jax.tree.map(np.asarray, jsys.meta_params)
             for (model, wr), jsys in jax_systems.items() if wr}
    work = tmp_path_factory.mktemp("spatial_warp")
    torch.save({"frames": frames, "trees": trees, "ops": ops,
                "exact64": exact64}, work / "inputs.pt")
    failed = []

    def run_ranks():
        try:
            spawn(_rank_cases, RANKS, args=(str(work),), timeout=600)
        except BaseException as e:  # re-raised after the runs here
            failed.append(e)
    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        refs = _jax_refs(jax_systems, frames)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)]
    one = {run: rank["one"][run] for rank in got for run in rank["one"]}
    yield {"ranks": got, "jax": refs, "one": one, "frames": frames}
    shutil.rmtree(work, ignore_errors=True)


def _ranks_of(shape):
    return [0, 1] if shape == "1x2" else list(range(RANKS))


@pytest.mark.parametrize("shape", list(SHARDS))
@pytest.mark.parametrize("op", OPS)
def test_row_aware_op_matches_whole_frame(ranks, shape, op):
    """The align_corners=False ×2 upsample (one halo row each way; the
    clamp at the frame's ends) and conv_as_input on bands of 4 rows and of
    1: values, the frame's gradient and the parameters' gradients."""
    for r in range(RANKS):
        case = ranks["ranks"][r]["ops"][shape][op]
        (want, want_g), (got, got_g) = case["want"], case["got"]
        assert got.shape == want.shape
        for a, b in zip((got,) + tuple(got_g), (want,) + tuple(want_g)):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= OP_RTOL * scale, (r, op)


@pytest.mark.parametrize("case", EXACT64, ids=lambda c: "-".join(
    str(v) for v in c if v is not None))
def test_full_width_bands_are_exact_in_float64(ranks, case):
    """The banded model on 4 bands is the whole frame's up to float64
    rounding, bounded (K3 / K3-grad's plain versions on bands) and exact:
    the prediction and every weight's gradient within 1e-10."""
    owner = ranks["ranks"][EXACT64.index(case) % RANKS]["exact64"][case]
    err, scale = owner["pred"]
    assert err <= EXACT64_RTOL * scale
    d, n = owner["grad"]
    assert d <= EXACT64_RTOL * n, (d, n)
    sums = [ranks["ranks"][r]["exact64"][case]["sums"]
            for r in range(RANKS)]
    assert all(s == sums[0] for s in sums)


def _run_id(run):
    return "-".join(str(v) for v in run)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_sharded_run_matches_one_process(ranks, run):
    """The same run in one process: only the order of the sums differs.
    Every rank holds the same prediction; a bounded run sampled only
    bands of its rank's rows, an exact one never the bounded sampler."""
    model, mode, shape, wr = run
    want = ranks["one"][run]
    scale = max(float(want["preds"].abs().max()),
                float(np.abs(_clips(run, ranks["frames"])).max()))
    first = ranks["ranks"][_ranks_of(shape)[0]]["runs"][run]
    bands = RANKS if shape == "1x4" else 2
    for r in _ranks_of(shape):
        got = ranks["ranks"][r]["runs"][run]
        assert torch.equal(got["preds"], first["preds"])
        err = float((got["preds"] - want["preds"]).abs().max())
        assert err <= SAME_PRED_RTOL * scale, (r, err, scale)
        if mode == "val":
            for key in ("loss", "psnr", "ssim"):
                assert abs(got["losses"][key] - want["losses"][key]) <= \
                    SAME_LOSS_RTOL * abs(want["losses"][key]) + 1e-7, key
        if not wr:
            assert got["samples"] == []
            continue
        assert got["samples"]
        for h, rows, row0 in got["samples"]:
            assert rows * bands == h and row0 == got["index"] * rows


@pytest.mark.parametrize("run", JAX_RUNS, ids=_run_id)
def test_sharded_run_matches_jax(ranks, run):
    """run_validation_iter on row bands against the JAX package unsharded:
    the prediction within 1e-4, the PSNR within 1e-3 dB."""
    want = ranks["jax"][run]
    for r in _ranks_of(run[2]):
        got = ranks["ranks"][r]["runs"][run]
        np.testing.assert_allclose(got["preds"].numpy(), want["preds"],
                                   atol=JAX_PRED_TOL, rtol=JAX_PRED_TOL)
        assert abs(got["losses"]["psnr"] - want["losses"]["psnr"]) \
            < JAX_PSNR_TOL
