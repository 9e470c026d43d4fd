"""The port's episode (task) parallelism over PyTorch ranks and its
row-sharded apply, held on the CPU against the JAX package's mesh runs
(on the virtual CPU devices of tests/conftest.py) and against the port
in one process.

Four gloo ranks are spawned once for the file (``parallel/launch.spawn``)
and run every multi-rank case (:func:`_rank_cases`); the tests below read
what they saved. The task cases run on a 2x2 mesh: 2-way task parallel,
each task slice replicated over a spatial axis of 2 (as JAX places a
batch on a mesh with a spatial axis and no --spatial_shards), so every
case also shows the two replicas agreeing. The halo cases run on 1x4.

Tolerances: the episode's loss 1e-5 relative (JAX's own test); the
outer loss 1e-5 and each tensor's outer gradient within 1e-3 of its norm
against JAX, and the parameters after the outer Adam step as
tests/test_torch_train.py holds them (a step is ~lr·sign(g), so an
element whose gradient is within rounding of zero may step the other
way); against the port in one process, where only the order of the
gradient's sum over tasks differs, the loss 1e-6, each group's gradient
1e-5 of its norm, the weights after the first outer step within the
bound the gradients' difference puts on it (``_assert_step_within``),
the discriminator's 1e-5; the folded BN statistics 1e-5; the halo
exchange bit for bit; the sharded conv stack 1e-5.
"""
import copy
import pathlib
import shutil

import numpy as np
import pytest
import torch

from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.core import checkpoint as bridge
from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
from meta_interpolation_tpu_torch.data.loader import (
    MetaLearningSystemDataLoader)
from meta_interpolation_tpu_torch.main import main
from meta_interpolation_tpu_torch.meta import episode
from meta_interpolation_tpu_torch.meta.inner_optimizers import (
    InnerOptimizer)
from meta_interpolation_tpu_torch.meta.system import (
    SceneAdaptiveInterpolation)
from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
from meta_interpolation_tpu_torch.parallel.launch import spawn

RANKS = 4
CROP = 32
LR = 1e-5
CAIN = dict(model="cain", depth=2, n_resblocks=1, loss="1*L1",
            optimizer="Adam", metasgd=True, inner_lr=LR, outer_lr=LR,
            number_of_training_steps_per_iter=1,
            number_of_evaluation_steps_per_iter=1, crop_size=CROP,
            batch_size=4, mode="train", num_workers=1)
VOXELFLOW = dict(model="voxelflow", loss="1*MSE", optimizer="Adam",
                 metasgd=True, inner_lr=LR, outer_lr=LR,
                 number_of_training_steps_per_iter=1,
                 number_of_evaluation_steps_per_iter=1, crop_size=CROP,
                 mode="train", batch_size=4, per_step_bn_statistics=True)
GAN = {"query": dict(CAIN, loss="1*L1+0.005*GAN"),
       "per_forward": dict(CAIN, loss="1*L1+0.005*GAN",
                           disc_per_forward=True)}
CLI = ["--model", "cain", "--depth", "2", "--n_resblocks", "1",
       "--crop_size", str(CROP), "--mode", "train", "--dataset",
       "synthetic", "--batch_size", "4", "--val_batch_size", "1",
       "--loss", "1*L1", "--optimizer", "Adam", "--metasgd", "--inner_lr",
       "1e-5", "--outer_lr", "1e-5", "--number_of_training_steps_per_iter",
       "1", "--number_of_evaluation_steps_per_iter", "1", "--max_epoch",
       "1", "--total_iter_per_epoch", "2", "--num_workers", "1",
       "--device", "cpu"]
TEST_CLI = ["--model", "cain", "--depth", "2", "--n_resblocks", "1",
            "--mode", "test", "--dataset", "test", "--test_batch_size", "2",
            "--number_of_evaluation_steps_per_iter", "1", "--num_workers",
            "1", "--device", "cpu"]
HALO, BAND = 2, 16
CONV_HALO, CONV_ROWS = 4, 64
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-3, 1e-12
STEP_ATOL, STEP_FLIP_SHARE = 0.1 * LR, 1e-5
SAME_RTOL, SAME_ATOL = 1e-5, 1e-7
STATS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread here, as in each rank: the one-process runs
    then compute each task as the ranks do (a convolution's float sums
    depend on the thread count), and only the order of the sum over
    tasks differs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clips(model, n, mode="train"):
    data = SyntheticSeptuplet(model=model, mode=mode, size=(CROP, CROP))
    return np.stack([np.asarray(data[i][0]) for i in range(n)])


class _Tiny(torch.nn.Module):
    """JAX test_parallel.py's tiny apply, w·(f0 + f1)/2 + b."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.7))
        self.b = torch.nn.Parameter(torch.tensor(0.05))

    def forward(self, f0, f1):
        return self.w * (f0 + f1) / 2.0 + self.b


def _tiny_episode(frames, mesh=None):
    """JAX's tiny-apply episode (Adam, Meta-SGD, 2 steps, second order)
    on (B, T, H, W, C) ``frames``; on a mesh this rank's slice, the
    gradient summed over the task axis. Returns (loss, grads)."""
    model = _Tiny().requires_grad_(False)
    opt = InnerOptimizer(rule="Adam", lr_mode="metasgd", num_steps=2)
    net = {k: p.detach() for k, p in model.named_parameters()}
    meta = {"net": net, "lrs": opt.init_lrs(net, 1e-3)}
    leaves = {g: {k: v.detach().clone().requires_grad_()
                  for k, v in tree.items()} for g, tree in meta.items()}
    builder = episode.EpisodeBuilder(
        model, lambda pred, target, aux=None: {
            "total": ((pred - target) ** 2).mean()}, opt)
    spec = episode.EpisodeSpec(num_steps=2, second_order=True)
    local = frames if mesh is None else mesh_lib.shard_task_batch(mesh,
                                                                  frames)
    x = torch.from_numpy(np.ascontiguousarray(
        local.transpose(0, 1, 4, 2, 3)))
    _, aux = builder.batched_episode(leaves, x, np.ones(2), spec,
                                     training=True, num_tasks=len(frames))
    grads = {g: {k: v.grad for k, v in tree.items()}
             for g, tree in leaves.items()}
    losses = aux["task_losses"]
    if mesh is not None:
        grads = mesh_lib.all_reduce_grads(
            mesh, grads, {g: dict.fromkeys(t, True)
                          for g, t in grads.items()})
        losses = mesh_lib.gather_tasks(mesh, losses)
    return float(losses.mean()), grads


def _train_step(cfg, frames, mesh=None, meta=None):
    """One run_train_iter of a system of ``cfg`` (CPU), its meta-params
    optionally set to ``meta`` first: the losses, the outer gradient
    before the step, the predictions and the meta-parameters after."""
    system = SceneAdaptiveInterpolation(Config(**cfg, device="cpu"),
                                        mesh=mesh)
    if meta is not None:
        with torch.no_grad():
            for g, tree in meta.items():
                for k, v in tree.items():
                    system.meta_params[g][k].copy_(v)
    before = copy.deepcopy(system.meta_params)
    taken = []
    real = system.outer_grads
    system.outer_grads = lambda *a, **k: taken.append(real(*a, **k)) or \
        taken[0]
    losses, preds = system.run_train_iter(frames, 0, do_evaluation=True)
    return {"losses": losses, "grads": taken[0][2], "preds": preds,
            "before": before, "after": copy.deepcopy(system.meta_params)}


def _conv_stack(params, f0, f1):
    """JAX test_parallel.py's two-conv stack, NCHW."""
    x = (f0 + f1) / 2
    h = torch.relu(torch.nn.functional.conv2d(x, params["c1.weight"],
                                              params["c1.bias"], padding=1))
    return torch.nn.functional.conv2d(h, params["c2.weight"],
                                      params["c2.bias"], padding=1)


def _rank_cases(rank, work):
    """Every multi-rank case, in one of the spawned ranks; what it
    computes is saved to ``work/rank<rank>.pt`` for the tests."""
    import contextlib

    import torch.distributed as dist

    from meta_interpolation_tpu_torch.parallel import spatial
    torch.set_num_threads(1)
    work = pathlib.Path(work)
    mesh_lib.init_distributed("cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    m22 = mesh_lib.make_mesh("2x2")
    m14 = mesh_lib.make_mesh("1x4")
    out = {"coords": (m22.task_index, m22.spatial_index)}
    out["tiny"] = _tiny_episode(inputs["tiny"], m22)
    out["cain"] = _train_step(CAIN, inputs["cain"], m22, inputs["cain_meta"])
    vf = _train_step(VOXELFLOW, inputs["voxelflow"], m22)
    out["bn"] = {"before": vf["before"]["bn_state"],
                 "after": vf["after"]["bn_state"]}
    out["gan"] = {}
    for cadence, cfg in GAN.items():
        step = _train_step(cfg, inputs["cain"], m22)
        out["gan"][cadence] = {"loss": step["losses"]["loss"],
                               "disc": step["after"]["loss_ctx"]}
    band = spatial.shard_rows(m14, inputs["halo"])
    out["halo"] = spatial.halo_exchange(band, HALO, m14.spatial_group)
    f0, f1 = inputs["conv_frames"]
    rows = spatial.spatial_sharded_apply(_conv_stack, m14, CONV_HALO)(
        inputs["conv"], f0, f1)
    out["conv_rows"] = spatial.gather_rows(m14, rows)
    with open(work / f"stdout{rank}.txt", "w") as log, \
            contextlib.redirect_stdout(log):
        out["cli"] = main(CLI + ["--mesh_shape", "2x2", "--checkpoint_dir",
                                 str(work / f"ck{rank}")])
        out["test"] = main(TEST_CLI + ["--mesh_shape", "2x2", "--data_root",
                                       str(work / "frames"),
                                       "--checkpoint_dir",
                                       str(work / f"ck{rank}")])
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _write_frames(directory, count=6, hw=(CROP, CROP)):
    from PIL import Image
    directory.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(3)
    for i in range(count):
        Image.fromarray(rs.randint(0, 256, hw + (3,), np.uint8)).save(
            directory / f"f{i:02d}.png")


def _jax_cain_init():
    import jax

    from meta_interpolation_tpu.config import Config as JaxConfig
    from meta_interpolation_tpu.meta.system import (
        SceneAdaptiveInterpolation as JaxSystem)
    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    jsys = JaxSystem(JaxConfig(**{k: v for k, v in CAIN.items()
                                  if k != "num_workers"}),
                     mesh=jax_mesh.make_mesh("2", jax.devices()[:2]))
    model = SceneAdaptiveInterpolation(Config(**CAIN, device="cpu")).model
    np_tree = jax.tree.map(np.asarray, jsys.meta_params)
    meta = {g: bridge.params_from_jax(np_tree[g], model)
            for g in ("net", "lrs")}
    return jsys, model, meta


@pytest.fixture(scope="module")
def inputs():
    import jax

    from meta_interpolation_tpu.models import layers as jax_layers
    rs = np.random.RandomState(0)
    jsys, model, meta = _jax_cain_init()
    p1 = jax_layers.conv_init(jax.random.PRNGKey(0), 3, 8, 3)
    p2 = jax_layers.conv_init(jax.random.PRNGKey(1), 8, 3, 3)
    conv = {f"{name}.{leaf}": torch.from_numpy(np.array(
        p[key]).transpose(3, 2, 0, 1) if key == "kernel" else np.array(
            p[key])).contiguous()
        for name, p in (("c1", p1), ("c2", p2))
        for key, leaf in (("kernel", "weight"), ("bias", "bias"))}
    return {
        "tiny": rs.rand(8, 7, 8, 8, 3).astype(np.float32),
        "cain": _clips("cain", 4), "cain_meta": meta, "jax_cain": jsys,
        "voxelflow": _clips("voxelflow", 4),
        "halo": torch.from_numpy(rs.rand(1, 2, BAND * RANKS, 5)
                                 .astype(np.float32)),
        "conv": conv, "conv_jax": {"c1": p1, "c2": p2},
        "conv_frames": tuple(torch.from_numpy(
            rs.rand(1, CONV_ROWS, 16, 3).astype(np.float32)
            .transpose(0, 3, 1, 2).copy()) for _ in range(2)),
        "cain_model": model}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Spawn the ranks once; their saved results, and the work directory
    (removed after the file's tests: it holds checkpoints)."""
    work = tmp_path_factory.mktemp("ranks")
    _write_frames(work / "frames")
    torch.save({k: v for k, v in inputs.items()
                if k not in ("jax_cain", "conv_jax", "cain_model")},
               work / "inputs.pt")
    spawn(_rank_cases, RANKS, args=(str(work),), timeout=300)
    yield [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)], work
    shutil.rmtree(work, ignore_errors=True)


# -- the mesh's arithmetic, against JAX's ------------------------------

@pytest.mark.parametrize("shape,n,dims", [(None, 8, (8, 1)),
                                          ("4x2", 8, (4, 2)),
                                          ("4", 4, (4, 1)),
                                          ("1x8", 8, (1, 8)),
                                          ("2", 2, (2, 1))])
def test_make_mesh_shapes(shape, n, dims):
    import jax

    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    jm = jax_mesh.make_mesh(shape, jax.devices()[:n])
    assert jm.devices.shape == dims
    for rank in range(n):
        m = mesh_lib.make_mesh(shape, world_size=n, rank=rank)
        assert (m.task, m.spatial) == dims
        where = np.argwhere(jm.devices == jax.devices()[rank])[0]
        assert (m.task_index, m.spatial_index) == tuple(where)


@pytest.mark.parametrize("shape", ["3x2", "2x2x2", "16"])
def test_make_mesh_rejects_as_jax_does(shape):
    import jax

    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(shape, jax.devices())
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(shape, world_size=8)


def test_make_mesh_over_some_ranks():
    """A mesh over the first ranks (the spatial-only mesh of
    --episode_parallel false): the others get None."""
    assert mesh_lib.make_mesh("1x2", world_size=4, rank=3,
                              ranks=[0, 1]) is None
    m = mesh_lib.make_mesh("1x2", world_size=4, rank=1, ranks=[0, 1])
    assert (m.task, m.spatial, m.spatial_index) == (1, 2, 1)


@pytest.mark.parametrize("shape,batch", [("8", 6), ("8", 8), ("4x2", 6),
                                         ("1x8", 3), (None, 3)])
def test_validate_train_batch_as_jax(shape, batch):
    import jax

    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    jm = jax_mesh.make_mesh(shape, jax.devices()) if shape else None
    m = mesh_lib.make_mesh(shape, world_size=8) if shape else None
    try:
        jax_mesh.validate_train_batch(jm, batch)
        refused = False
    except ValueError:
        refused = True
    if refused:
        with pytest.raises(ValueError, match="task"):
            mesh_lib.validate_train_batch(m, batch)
    else:
        mesh_lib.validate_train_batch(m, batch)
    assert refused == (shape in ("8", "4x2") and batch == 6)


def test_undividable_train_batch_rejected_by_the_system():
    m = mesh_lib.make_mesh("2", world_size=2)
    with pytest.raises(ValueError, match="task"):
        SceneAdaptiveInterpolation(Config(**dict(CAIN, batch_size=3),
                                          device="cpu"), mesh=m)


@pytest.mark.parametrize("shape,batch", [("8", 8), ("4x2", 8), ("2x4", 6),
                                         ("8", 3), ("4", 2)])
def test_shard_task_batch_is_jax_placement(shape, batch):
    """Each rank's slice is what JAX places on that rank's device; a batch
    the task axis does not divide stays whole on every rank (JAX's
    replicated fallback)."""
    import jax

    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    n = int(np.prod([int(x) for x in shape.split("x")]))
    x = np.random.RandomState(0).rand(batch, 2, 4, 4, 3).astype("float32")
    placed = jax_mesh.shard_task_batch(jax_mesh.make_mesh(
        shape, jax.devices()[:n]), x)
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank in range(n):
        got = mesh_lib.shard_task_batch(
            mesh_lib.make_mesh(shape, world_size=n, rank=rank), x)
        np.testing.assert_array_equal(got, shards[jax.devices()[rank]])
    if batch % int(shape.split("x")[0]):
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("task_size", [1, 8])
def test_train_loader_drops_the_tail_as_jax(task_size):
    from meta_interpolation_tpu.config import Config as JaxConfig
    from meta_interpolation_tpu.data.loader import (
        MetaLearningSystemDataLoader as JaxLoader)
    kw = dict(model="cain", dataset="synthetic", batch_size=3,
              val_batch_size=3, crop_size=16, num_workers=1)
    data = MetaLearningSystemDataLoader(Config(**kw), mesh_task_size=task_size)
    want = JaxLoader(JaxConfig(**kw), mesh_task_size=task_size)
    for split in ("get_train_batches", "get_val_batches"):
        got = [b[0] for b in getattr(data, split)()]
        exp = [b[0] for b in getattr(want, split)()]
        assert [len(b) for b in got] == [len(b) for b in exp]
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
    sizes = [len(b[0]) for b in data.get_train_batches()]
    n = len(data.dataset)
    assert sizes == ([3] * (n // 3) if task_size > 1
                     else [3] * (n // 3) + ([n % 3] if n % 3 else []))


def test_spatial_shards_still_refused():
    """Training runs on row bands (tests/test_torch_band_train.py); what
    it does not cover yet, here --remat, still raises."""
    with pytest.raises(NotImplementedError, match="--spatial_shards"):
        SceneAdaptiveInterpolation(Config(**dict(CAIN, spatial_shards=2,
                                                 remat=True),
                                          device="cpu"))
    with pytest.raises(ValueError, match="only one device"):
        main(CLI + ["--spatial_shards", "2"])


# -- the ranks' runs ----------------------------------------------------

def test_ranks_sit_on_a_2x2_mesh(ranks):
    got, _ = ranks
    assert [r["coords"] for r in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_episode_parallel_matches_one_rank_and_jax(inputs, ranks):
    """JAX test_parallel.py's tiny-apply episode: the port's 2 task
    ranks = the port in one process = JAX on make_mesh("2")."""
    import jax
    import jax.numpy as jnp

    from meta_interpolation_tpu.meta.episode import (
        EpisodeBuilder as JaxBuilder, EpisodeSpec as JaxSpec)
    from meta_interpolation_tpu.meta.inner_optimizers import (
        InnerOptimizer as JaxOpt)
    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    got, _ = ranks
    frames = inputs["tiny"]
    opt = JaxOpt(rule="Adam", lr_mode="metasgd", num_steps=2)
    params = {"w": jnp.asarray(0.7), "b": jnp.asarray(0.05)}
    builder = JaxBuilder(lambda p, f0, f1: p["w"] * (f0 + f1) / 2.0 + p["b"],
                         lambda pred, target, aux=None: {
                             "total": jnp.mean((pred - target) ** 2)}, opt)
    spec = JaxSpec(num_steps=2, second_order=True)
    m = jax_mesh.make_mesh("2", jax.devices()[:2])
    run = jax.jit(lambda mp, fr: builder.batched_episode(
        mp, fr, jnp.ones((2,)), spec, training=True)[0])
    want = float(run(jax_mesh.replicate_params(
        m, {"net": params, "lrs": opt.init_lrs(params, 1e-3)}),
        jax_mesh.shard_task_batch(m, jnp.asarray(frames))))
    one_loss, one_grads = _tiny_episode(frames)
    np.testing.assert_allclose(one_loss, want, rtol=LOSS_RTOL)
    for rank in got:
        loss, grads = rank["tiny"]
        np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, one_loss, rtol=1e-6)
        for g in one_grads:
            for k, v in one_grads[g].items():
                torch.testing.assert_close(grads[g][k], v, rtol=SAME_RTOL,
                                           atol=SAME_ATOL)


def _jax_mu(state):
    """The first moment of the outer Adam state: (1 − b1)·g after a
    first step."""
    if hasattr(state, "mu"):
        return state.mu
    if hasattr(state, "inner_state"):
        return _jax_mu(state.inner_state)
    if isinstance(state, tuple):
        for s in state:
            mu = _jax_mu(s)
            if mu is not None:
                return mu
    return None


@pytest.fixture(scope="module")
def jax_cain_step(inputs):
    """JAX's system on a 2-device mesh, one run_train_iter on the batch:
    its losses, its outer gradient (from the Adam state's first moment)
    and its meta-parameters after, in the port's layout."""
    import jax
    jsys, model = inputs["jax_cain"], inputs["cain_model"]
    losses, _ = jsys.run_train_iter(inputs["cain"], 0, do_evaluation=True)
    mu = jax.tree.map(np.asarray, _jax_mu(jsys.opt_state))
    after = jax.tree.map(np.asarray, jsys.meta_params)
    return losses, {g: {k: v / 0.1 for k, v in bridge.params_from_jax(
        mu[g], model).items()} for g in ("net", "lrs")}, {
        g: bridge.params_from_jax(after[g], model) for g in ("net", "lrs")}


def test_cain_train_iteration_matches_jax_on_a_mesh(ranks, jax_cain_step):
    """A tiny CAIN's run_train_iter at batch 4 (Adam, Meta-SGD, first
    order) on 2 task ranks against JAX's system on make_mesh("2"): the
    losses and PSNR, each tensor's outer gradient, and the step."""
    got, _ = ranks
    want_losses, want_grads, want_after = jax_cain_step
    step = got[0]["cain"]
    np.testing.assert_allclose(step["losses"]["loss"], want_losses["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(step["losses"]["total"], want_losses["total"],
                               rtol=LOSS_RTOL)
    assert abs(step["losses"]["psnr"] - want_losses["psnr"]) <= 1e-3
    assert step["preds"].shape == (4, 3, CROP, CROP)
    for group in ("net", "lrs"):
        for name, w in want_grads[group].items():
            err = float((step["grads"][group][name] - w).norm())
            assert err <= GRAD_RTOL * float(w.norm()) + GRAD_ATOL, (
                group, name, err, float(w.norm()))
    flips = total = moved = 0
    for group in ("net", "lrs"):
        for name, w in want_after[group].items():
            before = step["before"][group][name]
            d_got = step["after"][group][name] - before
            diff = (d_got - (w - before)).abs()
            assert float(diff.max()) <= 2.5 * LR, (group, name)
            flips += int((diff > STEP_ATOL).sum())
            total += diff.numel()
            moved += int((d_got.abs() > 0.5 * LR).sum())
    assert flips <= STEP_FLIP_SHARE * total, (flips, total)
    assert moved > 0.1 * total, (moved, total)


def _group_rel(got, want):
    """‖got − want‖ / ‖want‖ over each parameter group."""
    return {g: float(torch.sqrt(sum(((got[g][k] - v).double() ** 2).sum()
                                    for k, v in want[g].items())
                                / sum((v.double() ** 2).sum()
                                      for v in want[g].values())))
            for g in ("net", "lrs")}


def _assert_step_within(got, want, lr=LR, eps=1e-8):
    """The weights after a first Adam (or Adamax) step, which moves each
    by lr·g/(|g| + eps): two runs whose gradients differ by Δg may differ
    by lr·min(2, |Δg|/eps) (the step's slope is at most 1/eps, at g = 0,
    where a gradient within rounding of zero steps either way), plus the
    rounding of each side's subtraction (an ulp of the weight) and of the
    step itself."""
    for g in ("net", "lrs"):
        for k, w in want["after"][g].items():
            dp = (got["after"][g][k] - w).abs().double()
            dg = (got["grads"][g][k] - want["grads"][g][k]).abs().double()
            bound = (lr * torch.clamp(dg / eps, max=2.0)
                     + 2 * w.abs().double() * 2.0 ** -23 + 1e-6 * lr)
            assert bool((dp <= bound).all()), (g, k, float(dp.max()))


def test_cain_ranks_match_one_process(inputs, ranks):
    """The ranks against the port in one process on the same batch and
    weights: the loss, each group's gradient before the step (within 1e-5
    of its norm: only the order of the sum over tasks differs), the
    weights after the step by :func:`_assert_step_within`, and the
    predictions; the spatial replicas and the task ranks hold the same
    weights."""
    got, _ = ranks
    one = _train_step(CAIN, inputs["cain"], meta=inputs["cain_meta"])
    for rank in got:
        step = rank["cain"]
        np.testing.assert_allclose(step["losses"]["loss"],
                                   one["losses"]["loss"], rtol=1e-6)
        torch.testing.assert_close(step["preds"], one["preds"])
        assert max(_group_rel(step["grads"], one["grads"]).values()) \
            <= SAME_RTOL
        _assert_step_within(step, one)
        for g in ("net", "lrs"):
            for k, v in got[0]["cain"]["after"][g].items():
                assert torch.equal(step["after"][g][k], v)


def test_per_step_bn_fold_across_ranks(inputs, ranks):
    """VoxelFlow --per_step_bn_statistics at batch 4: the statistics the
    ranks write back (each task rank folds its 2 tasks in turn, the ranks'
    results folded in rank order) against JAX's
    fold_bn_states_sequential of the 4 tasks each run from the start, and
    against the port's one-process fold, task after task."""
    import jax.numpy as jnp

    from meta_interpolation_tpu.meta import episode as jax_episode
    got, _ = ranks
    frames = inputs["voxelflow"]
    one = _train_step(VOXELFLOW, frames)
    system = SceneAdaptiveInterpolation(Config(**VOXELFLOW, device="cpu"))
    s0 = {k: v.numpy() for k, v in system.meta_params["bn_state"].items()}
    per_task = [system.outer_grads(frames[i:i + 1], 0)[1]["bn_state"]
                for i in range(len(frames))]
    cfg = system.cfg
    spec = jax_episode.EpisodeSpec(support_idxs=cfg.support_idxs("train"),
                                   num_steps=cfg.num_inner_steps,
                                   use_msl=False)
    want = jax_episode.fold_bn_states_sequential(
        {k: jnp.asarray(v) for k, v in s0.items()},
        {k: jnp.asarray(np.stack([t[k].numpy() for t in per_task]))
         for k in s0}, spec)
    for rank in got:
        assert set(rank["bn"]["after"]) == set(s0)
        for k, v in rank["bn"]["after"].items():
            np.testing.assert_array_equal(rank["bn"]["before"][k].numpy(),
                                          s0[k])
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       atol=STATS_ATOL, rtol=0)
            np.testing.assert_allclose(v.numpy(),
                                       one["after"]["bn_state"][k].numpy(),
                                       atol=STATS_ATOL, rtol=0)
            assert not np.allclose(v.numpy(), s0[k], atol=1e-3)


def test_fold_of_blocks_is_the_fold_of_tasks():
    """fold_bn_states_sequential over 2 blocks of 2 tasks (tasks_each=2)
    equals it over the 4 tasks, the blocks' states themselves folds."""
    spec = episode.EpisodeSpec(num_steps=2, use_msl=True)
    rs = np.random.RandomState(4)
    s0 = {"m": torch.from_numpy(rs.rand(2, 5)).double()}
    a = torch.from_numpy((1 - episode.BN_MOMENTUM) ** episode.bn_update_counts(
        spec, 2)).reshape(2, 1)
    tasks = [a * s0["m"] + torch.from_numpy(rs.rand(2, 5)) for _ in range(4)]
    one = episode.fold_bn_states_sequential(
        s0, {"m": torch.stack(tasks)}, spec)["m"]
    blocks = [episode.fold_bn_states_sequential(
        s0, {"m": torch.stack(tasks[i:i + 2])}, spec)["m"] for i in (0, 2)]
    two = episode.fold_bn_states_sequential(
        s0, {"m": torch.stack(blocks)}, spec, tasks_each=2)["m"]
    torch.testing.assert_close(two, one, rtol=1e-12, atol=1e-12)
    seq = s0["m"]
    for t in tasks:
        seq = t + a * (seq - s0["m"])
    torch.testing.assert_close(one, seq, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cadence", list(GAN))
def test_discriminator_step_on_ranks(inputs, ranks, cadence):
    """1*L1+0.005*GAN on the tiny CAIN: every rank steps the
    discriminator on the global batch's predictions (the replay's
    support predictions too under --disc_per_forward), so its weights
    after the step are the one-process run's."""
    got, _ = ranks
    one = _train_step(GAN[cadence], inputs["cain"])
    want = one["after"]["loss_ctx"]
    moved = sum(float((want[k] - one["before"]["loss_ctx"][k]).abs().max())
                for k in want)
    assert moved > 0
    for rank in got:
        gan = rank["gan"][cadence]
        np.testing.assert_allclose(gan["loss"], one["losses"]["loss"],
                                   rtol=1e-6)
        for k, v in want.items():
            torch.testing.assert_close(gan["disc"][k], v, rtol=SAME_RTOL,
                                       atol=SAME_ATOL)


def test_halo_exchange_matches_jax_bit_for_bit(inputs, ranks):
    """halo_exchange on 4 ranks against JAX's on make_mesh("1x4"): each
    band padded with its neighbours' rows, the end bands reflected."""
    import jax
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    from meta_interpolation_tpu.parallel.spatial import (
        halo_exchange as jax_halo)
    got, _ = ranks
    m = jax_mesh.make_mesh("1x4", jax.devices()[:RANKS])
    x = inputs["halo"].numpy().transpose(0, 2, 3, 1)   # NHWC
    out = np.asarray(shard_map(
        lambda blk: jax_halo(blk, HALO), mesh=m,
        in_specs=P(None, jax_mesh.SPATIAL_AXIS),
        out_specs=P(None, jax_mesh.SPATIAL_AXIS), check_vma=False)(
        jax.device_put(x, NamedSharding(m, P(None, jax_mesh.SPATIAL_AXIS)))))
    rows = BAND + 2 * HALO
    for i, rank in enumerate(got):
        np.testing.assert_array_equal(
            rank["halo"].numpy().transpose(0, 2, 3, 1),
            out[:, i * rows:(i + 1) * rows])


def test_spatial_sharded_apply_matches_jax(inputs, ranks):
    """A two-conv stack on 4 row bands with a halo of 4: the frame
    assembled from the bands against JAX's spatial_sharded_apply on
    make_mesh("1x4") (every row, the reflected ends too), and against the
    dense apply on interior rows."""
    import jax

    from meta_interpolation_tpu.models import layers as jax_layers
    from meta_interpolation_tpu.parallel import mesh as jax_mesh
    from meta_interpolation_tpu.parallel.spatial import (
        spatial_sharded_apply as jax_apply)
    got, _ = ranks

    def apply_fn(params, f0, f1):
        x = (f0 + f1) / 2
        h = jax.nn.relu(jax_layers.conv2d(params["c1"], x, padding=1))
        return jax_layers.conv2d(params["c2"], h, padding=1)

    f0, f1 = inputs["conv_frames"]
    nhwc = [f.numpy().transpose(0, 2, 3, 1) for f in (f0, f1)]
    want = np.asarray(jax_apply(apply_fn, jax_mesh.make_mesh(
        "1x4", jax.devices()[:RANKS]), halo=CONV_HALO)(
        inputs["conv_jax"], *nhwc)).transpose(0, 3, 1, 2)
    dense = _conv_stack(inputs["conv"], f0, f1)
    inner = slice(CONV_HALO, -CONV_HALO)
    for rank in got:
        rows = rank["conv_rows"]
        assert rows.shape == dense.shape
        np.testing.assert_allclose(rows.numpy(), want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rows[:, :, inner].numpy(),
                                   dense[:, :, inner].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_only_rank_0_writes(ranks, tmp_path):
    """The training CLI on the 2x2 mesh, each rank given a checkpoint
    directory of its own: only rank 0's is written and only rank 0
    logs; every rank returns the same best PSNR, and the weights equal a
    one-process run's within 1e-5 of each tensor's norm (the Meta-SGD
    rates, which move by ~lr·sign(g) a step, of their group's)."""
    got, work = ranks
    for r in range(RANKS):
        log = (work / f"stdout{r}.txt").read_text()
        assert ("[epoch 0 it 0]" in log) == (r == 0), log
        assert ("[val epoch 0]" in log) == (r == 0), log
        assert (work / f"ck{r}").exists() == (r == 0)
        assert got[r]["cli"] == got[0]["cli"]
    main(CLI + ["--checkpoint_dir", str(tmp_path)])
    want = torch.load(tmp_path / "exp" / "checkpoint.pth",
                      weights_only=False)
    shutil.rmtree(tmp_path / "exp")
    state = torch.load(work / "ck0" / "exp" / "checkpoint.pth",
                       weights_only=False)
    assert state["epoch"] == want["epoch"] == 1
    assert state["best_PSNR"] == pytest.approx(want["best_PSNR"], abs=1e-4)
    got_meta = state["system"]["meta_params"]
    want_meta = want["system"]["meta_params"]
    for k, v in want_meta["net"].items():
        err = float((got_meta["net"][k] - v).norm())
        assert err <= SAME_RTOL * float(v.norm()), (k, err)
    assert max(_group_rel(got_meta, want_meta).values()) <= SAME_RTOL


def test_test_mode_on_ranks(ranks, tmp_path):
    """--mode test on the 2x2 mesh at test batch 2 (a batch split over
    the task ranks, then a partial one run whole): rank 0 alone renamed
    the frames and wrote the midpoints, which equal a one-process run's
    within one 8-bit level."""
    from PIL import Image
    got, work = ranks
    _write_frames(tmp_path)
    main(TEST_CLI + ["--data_root", str(tmp_path), "--checkpoint_dir",
                     str(tmp_path / "ck")])
    written = sorted(p.name for p in (work / "frames").glob("*.png"))
    want = sorted(p.name for p in tmp_path.glob("*.png"))
    assert written == want
    assert [r["test"] for r in got] == [3, 0, 0, 0]
    for name in want:
        a = np.asarray(Image.open(work / "frames" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / name), np.int16)
        assert np.abs(a - b).max() <= 1, name
