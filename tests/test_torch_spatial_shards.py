"""The port's exact row-sharded evaluation (``--spatial_shards``) of
SepConv and CAIN, held on the CPU against the JAX package (unsharded, and
its own ``--spatial_shards`` run on a mesh of 4 of the virtual CPU devices
of tests/conftest.py) and against the port in one process.

Four gloo ranks are spawned once for the file (``parallel/launch.spawn``)
and run every multi-rank case (:func:`_rank_cases`) on three meshes: 1x4
(4 bands), 2x2 (2 tasks of 2 bands) and 1x2 over ranks 0 and 1; the
parent computes the JAX references while they run, and the tests below
read what both saved.

Tolerances: against JAX, JAX's own spatial test's, the prediction 1e-4
(absolute and relative) and the PSNR 1e-3 dB; against the port in one
process, where only the order of the sums differs, the prediction within
1e-5 of the larger of its and the frames' largest value (a random-init
SepConv predicts ~2e-3 from frames of ~1, as a sum of products of frame
values) and the loss 1e-6 relative; the halo exchange
bit for bit; each row-aware op against the whole frame's, in float64,
1e-6 of the largest value of its output and of each gradient; the
full-width CAIN and SepConv on 4 bands in float64, 1e-10 of the
prediction's largest value and of the gradient's norm; the collectives'
adjoints by ``torch.autograd.gradcheck`` in float64, and their backwards'
by ``gradgradcheck`` (a backward that ran a collective off the tape would
drop the neighbours' part of a second-order gradient; training on bands is
held in tests/test_torch_band_train.py).
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
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.models import cain, layers, sepconv
from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
from meta_interpolation_tpu_torch.parallel import spatial
from meta_interpolation_tpu_torch.parallel.launch import spawn

RANKS = 4
CROP = 32
# JAX tests/test_parallel.py's spatial case (CAIN, depth 2, one RCAB,
# crop 32, 2 clips), evaluated with run_cain.sh's hyperparameters
CAIN = dict(model="cain", depth=2, n_resblocks=1, crop_size=CROP,
            loss="1*L1", optimizer="Adam", metasgd=True, inner_lr=1e-5,
            number_of_evaluation_steps_per_iter=1)
# run_sepconv.sh's evaluation: Adamax, Meta-SGD, 3 inner steps; crop 32
# pads to a 128-row grid: bands of 32 rows at 4 shards, 1 at the deepest
# level
SEPCONV = dict(model="sepconv", crop_size=CROP, loss="1*L1",
               optimizer="Adamax", metasgd=True, inner_lr=1e-5,
               number_of_evaluation_steps_per_iter=3)
# CAIN on a 4-px grid: 36 rows shuffle to 9, which no mesh here splits
FALLBACK = dict(CAIN, pad_multiple=4)
FALLBACK_HW = (36, CROP)
# (model, mode, mesh) of every sharded run
RUNS = [("cain", "val", "1x4"), ("cain", "val", "2x2"),
        ("cain", "test", "1x4"), ("cain", "test", "2x2"),
        ("sepconv", "val", "1x2"), ("sepconv", "val", "1x4"),
        ("sepconv", "test", "1x4")]
# the runs held to JAX (SepConv's test mode is held to the port in one
# process: JAX's SepConv episode compiles for about a minute a mode)
JAX_RUNS = [run for run in RUNS if run[:2] != ("sepconv", "test")]
CLI = ["--model", "cain", "--depth", "2", "--n_resblocks", "1",
       "--crop_size", str(CROP), "--mode", "val", "--dataset", "synthetic",
       "--loss", "1*L1", "--optimizer", "Adam", "--metasgd", "--inner_lr",
       "1e-5", "--number_of_evaluation_steps_per_iter", "1",
       "--num_workers", "1", "--device", "cpu"]
JAX_PRED_TOL, JAX_PSNR_TOL = 1e-4, 1e-3
SAME_PRED_RTOL, SAME_LOSS_RTOL = 1e-5, 1e-6
OP_RTOL = 1e-6
EXACT64_RTOL = 1e-10
HALO = 2
# the row-aware ops, each on bands of 4 rows and (the *_1row ones) of 1
OPS = ["conv_zero", "convnorm_exact", "convnorm_zero", "convnorm_reflect",
       "upsample", "mean", "channel_attention", "conv_zero_1row",
       "upsample_1row"]
SHARDS = {"1x4": 4, "2x2": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(base, mode, **kw):
    return Config(**base, mode=mode, device="cpu", **kw)


def _op_module(name, ch):
    gen = torch.Generator().manual_seed(OPS.index(name))
    if name.startswith("conv_zero"):
        return layers.xavier_conv(ch, 5, 3, gen)
    if name.startswith("convnorm"):
        mode = {"exact": False, "zero": True, "reflect": "reflect"}[
            name.split("_")[1]]
        return cain.ConvNorm(ch, 5, 3, mode, gen)
    if name.startswith("upsample"):
        return layers.Upsample(2, align_corners=True)
    if name == "channel_attention":
        return cain.CALayer(ch, 2, gen)
    return _Mean()


class _Mean(torch.nn.Module):
    """The global mean, read by each band's own rows (as CAIN's channel
    attention reads it)."""

    def forward(self, x):
        return x * layers.global_avg_pool(x)


def _cotangent(name, grads):
    """The cotangent of an op's output, of its shape."""
    if name.startswith("upsample"):
        return grads["up"]
    return grads["conv"] if name.startswith("conv") else grads["same"]


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


class _Replicated(torch.autograd.Function):
    """A value every rank holds whole, as one variable: identity forward,
    the ranks' cotangents summed backward (:class:`_Summed`)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _Summed.apply(g, ctx.shard), None


class _Summed(torch.autograd.Function):
    """The ranks' parts summed into a value every rank holds whole, as one
    variable: the adjoint of :class:`_Replicated`, whose forward is its
    backward."""

    @staticmethod
    def forward(ctx, g, shard):
        ctx.shard = shard
        g = g.clone()
        torch.distributed.all_reduce(g, group=shard.group)
        return g

    @staticmethod
    def backward(ctx, gg):
        return _Replicated.apply(gg, ctx.shard), None


def _band_times_sum(band, shard):
    total = spatial.all_reduce_sum((band ** 2).sum(dim=-2, keepdim=True),
                                   shard)
    return spatial.gather_band(band * total, shard)


def _gradchecks(shard):
    """gradcheck in float64 of functions of a whole frame X that every
    rank holds: the halo exchange (X's band padded from its neighbours,
    the padded bands gathered), the all-reduced band sum (read by each
    band's rows, the bands gathered) and the band gather. Every rank runs the same checks in step, so each perturbation
    and each backward is one collective run."""
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(1, 2, 2 * HALO * shard.count, 3, generator=gen,
                   dtype=torch.float64, requires_grad=True)
    fns = {
        "halo": lambda x: spatial.gather_band(spatial.halo_rows(
            spatial.band(_Replicated.apply(x, shard), shard), HALO, shard),
            shard),
        "all_reduce_sum": lambda x: _band_times_sum(
            spatial.band(_Replicated.apply(x, shard), shard), shard),
        "gather_band": lambda x: spatial.gather_band(
            spatial.band(_Replicated.apply(x, shard), shard) * 3.0, shard)}
    return {name: torch.autograd.gradcheck(fn, (x,), raise_exception=False)
            for name, fn in fns.items()}


def _gradgradchecks(shard):
    """gradgradcheck in float64 of functions of a whole frame X that every
    rank holds, each through one band collective whose backward a second
    order differentiates: the halo exchange, the all-reduced band sum read
    by each band's rows, the gather of a squared band (its backward's
    adjoint gathers the bands' cotangents) and ``all_reduce_grads`` (a
    flat buffer of the bands' parts, read by each band's rows). Every rank
    runs the same checks in step, with the same output cotangents."""
    gen = torch.Generator().manual_seed(6)
    x = torch.rand(1, 2, 2 * HALO * shard.count, 3, generator=gen,
                   dtype=torch.float64, requires_grad=True)

    def band(x):
        return spatial.band(_Replicated.apply(x, shard), shard)

    def reduced_grads(x):
        b = band(x)
        total, = spatial.all_reduce_grads(
            [(b ** 2).sum(dim=-2, keepdim=True)], shard)
        return spatial.gather_band(b * total, shard)
    fns = {
        "halo": lambda x: spatial.gather_band(spatial.halo_rows(
            band(x) ** 2, HALO, shard), shard),
        "all_reduce_sum": lambda x: _band_times_sum(band(x), shard),
        "gather_band": lambda x: spatial.gather_band(band(x) ** 2, shard),
        "all_reduce_grads": reduced_grads}
    out = {}
    for name, fn in fns.items():
        gy = torch.rand(fn(x).shape, generator=gen, dtype=torch.float64,
                        requires_grad=True)
        out[name] = torch.autograd.gradgradcheck(
            fn, (x,), (gy,), raise_exception=False)
    return out


EXACT64 = ("cain", "sepconv")


def banded_summary(pred, grads, want=None):
    """What a rank saves of a banded run, its prediction and gradient
    (the bands' summed over the ranks, so the same on every rank): their
    sums and sums of squares and, given the whole frame's (prediction,
    gradient) on this rank, the prediction's largest difference from it
    and its largest value, the gradient's distance and norm. A rank's
    whole gradients would be gigabytes to save and load."""
    flat = torch.cat([g.flatten() for g in grads])
    out = {"sums": tuple(float(f(t)) for t in (pred, flat)
                         for f in (torch.sum, lambda t: t.square().sum()))}
    if want is not None:
        want_pred, want_grads = want
        out["pred"] = (float((pred - want_pred).abs().max()),
                       float(want_pred.abs().max()))
        out["grad"] = (sum(float((a - b).norm()) ** 2
                           for a, b in zip(grads, want_grads)) ** 0.5,
                       sum(float(b.norm()) ** 2 for b in want_grads) ** 0.5)
    return out


def _exact64(model, shard, f0, f1, target, whole):
    """A full-width model (CAIN: 5 groups of 12 RCABs, 192 channels) in
    float64 on this rank's band and, where ``whole`` (one rank a model),
    on the whole frame: the prediction and the gradient of its L1 loss in
    every weight (the bands' summed over the ranks), as
    :func:`banded_summary`."""
    net = (cain.CAIN if model == "cain" else sepconv.SepConv)(
        torch.Generator().manual_seed(0)).double()
    params = list(net.parameters())

    def run(context):
        with context:
            pred = net(f0, f1)
        return pred.detach(), torch.autograd.grad(
            (pred - target).abs().mean(), params)
    pred, grads = run(spatial.row_shard(shard))
    return banded_summary(pred, spatial.all_reduce_grads(grads, shard),
                          run(contextlib.nullcontext()) if whole else None)


def _system(base, mode, mesh, tree, **kw):
    system = SceneAdaptiveInterpolation(
        _cfg(base, mode, spatial_shards=mesh.spatial if mesh else 1, **kw),
        mesh=mesh)
    bridge.load_jax_meta_params(system, tree)
    return system


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
    # every halo exchange of the row-aware ops goes through here
    halos = [0]
    real_halo = spatial.halo_rows

    def counted(*args, **kwargs):
        halos[0] += 1
        return real_halo(*args, **kwargs)
    spatial.halo_rows = counted
    out = {"halo": {}, "gradcheck": {}, "gradgradcheck": {}, "ops": {},
           "runs": {}}
    for shape, count in SHARDS.items():
        shard = spatial.RowShard.of(meshes[shape])
        out["halo"][shape] = spatial.halo_rows(
            spatial.band(inputs["halo"], shard), HALO, shard)
        out["gradcheck"][shape] = _gradchecks(shard)
        out["gradgradcheck"][shape] = _gradgradchecks(shard)
        if count == RANKS:
            # the whole frame once, on one rank a model
            out["exact64"] = {
                model: _exact64(model, shard, *inputs["exact64"][model],
                                whole=i == rank)
                for i, model in enumerate(EXACT64)}
        out["ops"][shape] = {}
        for name in OPS:
            x, grads = inputs["ops"][count][
                "1row" if name.endswith("1row") else "band"]
            out["ops"][shape][name] = _op_case(name, shard, x,
                                               _cotangent(name, grads))
    for model, mode, shape in RUNS:
        mesh = meshes[shape]
        if mesh is None:
            continue
        halos[0] = 0
        base = CAIN if model == "cain" else SEPCONV
        run = _run(_system(base, mode, mesh, inputs["trees"][model]), mode,
                   inputs["frames"][model])
        out["runs"][(model, mode, shape)] = {**run, "halos": halos[0]}
    log = work / f"stdout{rank}.txt"
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        halos[0] = 0
        system = _system(FALLBACK, "val", meshes["1x4"],
                         inputs["trees"]["cain"])
        out["fallback"] = [_run(system, "val", inputs["frames"]["fallback"])
                           for _ in range(2)]
        out["fallback_halos"] = halos[0]
        out["cli"] = {
            "1x4": main(CLI + ["--spatial_shards", "4"]),
            "1x2": main(CLI + ["--spatial_shards", "2",
                               "--episode_parallel", "false"])}
    out["stdout"] = log.read_text()
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _jax_refs(systems, frames):
    """The JAX package's runs: CAIN and SepConv unsharded, and CAIN's
    validation under its own --spatial_shards 4 on a 1x4 mesh of 4
    virtual devices (JAX's GSPMD placement), with the same weights."""
    import jax
    from meta_interpolation_tpu.config import Config as JaxConfig
    from meta_interpolation_tpu.meta.system import (
        SceneAdaptiveInterpolation as JaxSystem)
    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    def nchw(preds):
        return np.asarray(preds).transpose(0, 3, 1, 2)
    refs = {}
    for model, jsys in systems.items():
        losses, preds = jsys.run_validation_iter(frames[model])
        refs[(model, "val")] = {"losses": losses, "preds": nchw(preds)}
        if model == "cain":
            refs[(model, "test")] = {"preds": nchw(
                jsys.run_test_iter(frames[model][:, :4]))}
    sharded = JaxSystem(JaxConfig(**CAIN, mode="val", spatial_shards=4),
                        mesh=jax_mesh.make_mesh("1x4", jax.devices()[:4]))
    sharded.meta_params = systems["cain"].meta_params
    losses, preds = sharded.run_validation_iter(frames["cain"])
    refs[("cain", "val", "jax_1x4")] = {"losses": losses,
                                        "preds": nchw(preds)}
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX systems' weights, then the ranks spawned once (in a thread)
    while the JAX references and the port in one process run here; the
    ranks' saved results beside them. The work directory is removed after
    the file's tests."""
    import jax

    from meta_interpolation_tpu.config import Config as JaxConfig
    from meta_interpolation_tpu.meta.system import (
        SceneAdaptiveInterpolation as JaxSystem)
    rs = np.random.RandomState(0)
    frames = {"cain": rs.rand(2, 7, CROP, CROP, 3).astype(np.float32),
              "sepconv": rs.rand(1, 7, CROP, CROP, 3).astype(np.float32),
              "fallback": rs.rand(1, 7, *FALLBACK_HW, 3).astype(np.float32)}
    ops = {}
    for count in SHARDS.values():
        ops[count] = {}
        for kind, rows in (("band", 4 * count), ("1row", count)):
            shapes = {"up": (1, 4, rows * 2, 12), "same": (1, 4, rows, 6),
                      "conv": (1, 5, rows, 6)}
            ops[count][kind] = (
                torch.from_numpy(rs.randn(1, 4, rows, 6)),
                {k: torch.from_numpy(rs.randn(*v))
                 for k, v in shapes.items()})
    # full width in float64: CAIN at 64x96 (16 shuffled rows), SepConv at
    # the crop
    exact64 = {model: tuple(torch.from_numpy(rs.rand(1, 3, *hw))
                            for _ in range(3))
               for model, hw in (("cain", (64, 96)), ("sepconv", (CROP,
                                                                  CROP)))}
    systems = {model: JaxSystem(JaxConfig(**base, mode="val"))
               for model, base in (("cain", CAIN), ("sepconv", SEPCONV))}
    trees = {m: jax.tree.map(np.asarray, s.meta_params)
             for m, s in systems.items()}
    work = tmp_path_factory.mktemp("spatial")
    torch.save({"frames": frames, "trees": trees, "ops": ops,
                "exact64": exact64,
                "halo": torch.from_numpy(rs.randint(
                    -1000, 1000, (1, 2, 8 * RANKS, 5)).astype(np.float32))},
               work / "inputs.pt")
    failed, one = [], {}

    def run_ranks():
        try:
            spawn(_rank_cases, RANKS, args=(str(work),), timeout=600)
        except BaseException as e:  # re-raised after the runs here
            failed.append(e)
    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        refs = _jax_refs(systems, frames)
        for model, mode in {(m, md) for m, md, _ in RUNS}:
            base = CAIN if model == "cain" else SEPCONV
            one[(model, mode)] = _run(
                _system(base, mode, None, trees[model]), mode, frames[model])
        one["fallback"] = _run(
            _system(FALLBACK, "val", None, trees["cain"]), "val",
            frames["fallback"])
    finally:
        thread.join()
    if failed:
        raise failed[0]
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)]
    yield {"ranks": got, "jax": refs, "one": one, "inputs": inputs,
           "frames": frames}
    shutil.rmtree(work, ignore_errors=True)


def _ranks_of(shape):
    return [0, 1] if shape == "1x2" else list(range(RANKS))


# -- the collectives ------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHARDS))
def test_halo_exchange_bit_for_bit(ranks, shape):
    """Each band padded with HALO rows of the bands above and below, zeros
    past the frame's ends, on integer-valued data."""
    x = ranks["inputs"]["halo"]
    count = SHARDS[shape]
    rows = x.shape[2] // count
    for r in range(RANKS):
        i = r % count
        lo, hi = i * rows, (i + 1) * rows
        zeros = torch.zeros(1, 2, HALO, x.shape[3])
        want = torch.cat([x[:, :, lo - HALO:lo] if i else zeros,
                          x[:, :, lo:hi],
                          x[:, :, hi:hi + HALO] if i < count - 1 else zeros],
                         dim=2)
        assert torch.equal(ranks["ranks"][r]["halo"][shape], want)


@pytest.mark.parametrize("shape", list(SHARDS))
@pytest.mark.parametrize("fn", ["halo", "all_reduce_sum", "gather_band"])
def test_collective_adjoints_gradcheck(ranks, shape, fn):
    for r in range(RANKS):
        assert ranks["ranks"][r]["gradcheck"][shape][fn], (r, shape, fn)


@pytest.mark.parametrize("shape", list(SHARDS))
@pytest.mark.parametrize("fn", ["halo", "all_reduce_sum", "gather_band",
                                "all_reduce_grads"])
def test_collective_backwards_are_twice_differentiable(ranks, shape, fn):
    """Each collective's backward is itself differentiable, with the
    forward as its adjoint: a backward that ran a collective off the tape
    gives the neighbours' part of a second-order gradient as zero, and
    fails here."""
    for r in range(RANKS):
        assert ranks["ranks"][r]["gradgradcheck"][shape][fn], (r, shape, fn)


@pytest.mark.parametrize("shape", list(SHARDS))
@pytest.mark.parametrize("op", OPS)
def test_row_aware_op_matches_whole_frame(ranks, shape, op):
    """Convolutions (zero, exact reflect, --fuse_pad's zero and reflect
    modes), the align_corners upsample, the global mean and CAIN's channel
    attention on bands (4 rows a band, and 1 row for SepConv's deepest
    level): values, the frame's gradient and the parameters' gradients."""
    for r in range(RANKS):
        case = ranks["ranks"][r]["ops"][shape][op]
        (want, want_g), (got, got_g) = case["want"], case["got"]
        assert got.shape == want.shape
        for a, b in zip((got,) + tuple(got_g), (want,) + tuple(want_g)):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= OP_RTOL * scale, (r, op)


@pytest.mark.parametrize("model", ["cain", "sepconv"])
def test_full_width_bands_are_exact_in_float64(ranks, model):
    """The banded model on 4 bands is the whole frame's up to float64
    rounding: the prediction and every weight's gradient within 1e-10
    (float32 rounds a random-init CAIN's gradient to ~1e-4 of its norm
    either way, so this is where exactness shows)."""
    owner = ranks["ranks"][EXACT64.index(model)]["exact64"][model]
    err, scale = owner["pred"]
    assert err <= EXACT64_RTOL * scale
    d, n = owner["grad"]
    assert d <= EXACT64_RTOL * n, (d, n)
    sums = [ranks["ranks"][r]["exact64"][model]["sums"]
            for r in range(RANKS)]
    assert all(s == sums[0] for s in sums)


# -- the episodes ---------------------------------------------------------

def _assert_close_to_jax(got, want):
    np.testing.assert_allclose(got["preds"].numpy(), want["preds"],
                               atol=JAX_PRED_TOL, rtol=JAX_PRED_TOL)
    if "losses" in want:
        assert abs(got["losses"]["psnr"] - want["losses"]["psnr"]) \
            < JAX_PSNR_TOL


@pytest.mark.parametrize("model,mode,shape", JAX_RUNS)
def test_sharded_run_matches_jax(ranks, model, mode, shape):
    """run_validation_iter / run_test_iter on row bands against JAX
    unsharded: the prediction within 1e-4, the PSNR within 1e-3 dB."""
    for r in _ranks_of(shape):
        _assert_close_to_jax(ranks["ranks"][r]["runs"][(model, mode, shape)],
                             ranks["jax"][(model, mode)])


def test_cain_matches_jax_spatial_shards(ranks):
    """The port's 1x4 bands against the JAX package's own --spatial_shards
    4 run on a 1x4 mesh (JAX tests/test_parallel.py's case)."""
    want = ranks["jax"][("cain", "val", "jax_1x4")]
    for r in range(RANKS):
        _assert_close_to_jax(ranks["ranks"][r]["runs"][("cain", "val", "1x4")],
                             want)


@pytest.mark.parametrize("model,mode,shape", RUNS)
def test_sharded_run_matches_one_process(ranks, model, mode, shape):
    """The same run in one process: only the order of the sums differs.
    Every rank holds the same prediction, and ran on bands (its halo
    exchanges counted)."""
    want = ranks["one"][(model, mode)]
    # a prediction is a sum of products of frame values (SepConv's at
    # random init ~2e-3 where the frames are ~1): its rounding is the
    # larger one's
    scale = max(float(want["preds"].abs().max()),
                float(np.abs(ranks["frames"][model]).max()))
    first = ranks["ranks"][_ranks_of(shape)[0]]["runs"][(model, mode, shape)]
    for r in _ranks_of(shape):
        got = ranks["ranks"][r]["runs"][(model, mode, shape)]
        assert got["halos"] > 0
        assert torch.equal(got["preds"], first["preds"])
        err = float((got["preds"] - want["preds"]).abs().max())
        assert err <= SAME_PRED_RTOL * scale, (r, err, scale)
        if mode == "val":
            for key in ("loss", "psnr", "ssim"):
                assert abs(got["losses"][key] - want["losses"][key]) <= \
                    SAME_LOSS_RTOL * abs(want["losses"][key]) + 1e-7, key


def test_unsplit_grid_runs_unsharded(ranks):
    """A frame whose grid does not split into bands (CAIN on a 4-px grid,
    9 shuffled rows over 4 bands) runs unsharded on every rank: no halo
    exchange, the one process's result on each, logged once."""
    want = ranks["one"]["fallback"]
    for r in range(RANKS):
        got = ranks["ranks"][r]
        assert got["fallback_halos"] == 0
        for run in got["fallback"]:
            assert torch.equal(run["preds"], want["preds"])
            assert run["losses"] == want["losses"]
        notes = got["stdout"].count("does not split into 4 bands")
        assert notes == (1 if r == 0 else 0)


def test_cli_spatial_shards(ranks):
    """``main`` under 4 ranks: --spatial_shards 4 lays them out 1x4;
    --spatial_shards 2 --episode_parallel false runs the first 2 as 1x2
    and leaves the others idle. Every rank of a mesh reports the one
    process's validation."""
    want = main(CLI)
    for r in range(RANKS):
        cli = ranks["ranks"][r]["cli"]
        for shape in ("1x4", "1x2"):
            if r not in _ranks_of(shape):
                assert cli[shape] is None
                continue
            for key in ("loss", "psnr", "ssim"):
                assert abs(cli[shape][key] - want[key]) <= \
                    SAME_LOSS_RTOL * abs(want[key]) + 1e-7, (r, shape, key)
    stdout = ranks["ranks"][0]["stdout"]
    assert "Mesh(task=1, spatial=4" in stdout
    assert "using 2/4 devices spatially" in stdout
    assert "outside the mesh, idle" in ranks["ranks"][3]["stdout"]


# -- what stays refused ---------------------------------------------------

REFUSED = {
    # training runs on bands (tests/test_torch_band_train.py): what stays
    # refused there
    "training": (dict(CAIN, batch_size=2, dtype="bfloat16"), "train",
                 "--dtype bfloat16"),
    "bf16": (dict(CAIN, dtype="bfloat16"), "val", "--dtype bfloat16"),
    "rrin": (dict(model="rrin", number_of_training_steps_per_iter=1,
                  batch_size=2, remat=True), "train", "--remat"),
    "superslomo": (dict(model="superslomo", loss="1*Super", metasgd=True,
                        dtype="bfloat16"), "val", "--dtype bfloat16"),
    "voxelflow": (dict(model="voxelflow", loss="1*MSE+0.1*VGG22",
                       metasgd=True), "val", "VGG22"),
    "dain": (dict(model="dain", optimizer="Adamax", metasgd=True), "val",
             "--model dain"),
    "vgg": (dict(CAIN, loss="1*L1+0.1*VGG22"), "val", "VGG22"),
    "ssim": (dict(CAIN, loss="1*SSIM"), "val", "SSIM"),
    "gan": (dict(CAIN, loss="1*L1+0.005*GAN"), "val", "GAN"),
    "attenuate": (dict(CAIN, attenuate=True), "val", "--attenuate"),
    "per_step_bn": (dict(model="voxelflow", loss="1*MSE", metasgd=True,
                         per_step_bn_statistics=True), "test",
                    "--per_step_bn_statistics"),
    "remat": (dict(SEPCONV, remat=True), "val", "--remat"),
    # in training, what stays refused (ROADMAP Queue 1, items 2.2, 2.4 and
    # 2.5)
    "train_bf16": (dict(SEPCONV, dtype="bfloat16"), "train",
                   "--dtype bfloat16"),
    "train_dain": (dict(model="dain", optimizer="Adamax", metasgd=True),
                   "train", "--model dain"),
    "train_vgg": (dict(SEPCONV, loss="1*L1+0.1*VGG22"), "train", "VGG22"),
    "train_ssim": (dict(CAIN, loss="1*L1+1*SSIM"), "train", "SSIM"),
    "train_gan": (dict(CAIN, loss="1*L1+0.005*WGAN_GP"), "train",
                  "WGAN_GP"),
    "train_attenuate": (dict(SEPCONV, attenuate=True), "train",
                        "--attenuate"),
    "train_per_step_bn": (dict(model="voxelflow", loss="1*MSE", metasgd=True,
                               per_step_bn_statistics=True), "train",
                          "--per_step_bn_statistics"),
    "train_remat": (dict(CAIN, remat=True), "train", "--remat"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_spatial_shards_refuses_what_is_not_ported(case):
    base, mode, named = REFUSED[case]
    with pytest.raises(NotImplementedError, match="--spatial_shards") as e:
        SceneAdaptiveInterpolation(_cfg(base, mode, spatial_shards=2))
    assert named in str(e.value)
