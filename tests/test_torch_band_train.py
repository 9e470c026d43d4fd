"""The port's row-sharded meta-training (``--mode train --spatial_shards``)
of SepConv, CAIN, RRIN, SuperSloMo and VoxelFlow, first and second order,
held on the CPU against the port in one process and against the JAX
package's unsharded train step.

Four gloo ranks are spawned once for the file (``parallel/launch.spawn``)
and run every case (:func:`_rank_cases`) on four meshes: 1x4 (4 bands),
2x2 (2 tasks of 2 bands), and 1x2 over ranks 0 and 1 and over ranks 2 and
3 (two runs at once); then the port in one process, one rank a run. The
parent computes the JAX references while they run, and the tests below
read what both saved.

Each run is one iteration's ``outer_grads``: the episode on each rank's
band, the support gradients summed over the bands at each inner step (on
the tape in second order, through the band collectives' twice
differentiable backwards), the outer gradient summed over every rank of
the mesh. Float64 runs, the port's seeded init: the outer loss and every
tensor of the net's and the rates' outer gradients within 1e-10
(relative) of one process's. First order runs each preset's inner rule;
second order the inner SGD rule, as tests/test_torch_warp_train.py's:
Adam's step lr·g/(|g| + eps) has the derivative eps/(|g| + eps)², up to
1e8 near g = 0, which turns float64 rounding into ~1e-9 of the gradient
(ROADMAP Queue 3). Float32 runs, JAX's weights: SepConv's second order
at run_sepconv.sh's inner Adamax (K1/K2 and the sepconv double backward
on each band) against JAX's train step as
tests/test_torch_train_second_order.py takes it, each group within 1e-3
of its norm; VoxelFlow's second order with R = 8 (K3, K3-grad and
K3-grad²'s plain versions on each band) at the inner SGD rule, each
tensor within 1e-3 of its norm.
"""
import importlib.util
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
from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
from meta_interpolation_tpu_torch.parallel.launch import spawn

# chip_smoke.py's float64 recast of a system
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
    / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

RANKS = 4
R = 8
# the presets at one task and at most one inner step; crops whose grids
# split into the runs' bands: SepConv and RRIN pad 32 rows to 128,
# SuperSloMo 64 to 64 (2 bands of 32), VoxelFlow 32 to 64
PRESETS = {
    "cain": dict(model="cain", depth=2, n_resblocks=1, crop_size=32,
                 loss="1*L1", optimizer="Adam", metasgd=True),
    "sepconv": dict(model="sepconv", crop_size=32, loss="1*L1",
                    optimizer="Adamax", metasgd=True),
    "rrin": dict(model="rrin", crop_size=32, loss="1*L1", optimizer="Adam",
                 number_of_training_steps_per_iter=0),
    "superslomo": dict(model="superslomo", crop_size=64, loss="1*Super",
                       optimizer="Adam", metasgd=True),
    "voxelflow": dict(model="voxelflow", crop_size=32, loss="1*MSE",
                      optimizer="Adam", metasgd=True),
}
# (model, order, mesh, --fast_warp_range) of every float64 run; CAIN's
# 2x2 run takes 2 tasks, a task group each. The full-width models run on
# the 1x2 meshes, where their halos cost least
RUNS = [("voxelflow", "first", "1x4", 0), ("voxelflow", "second", "1x4", R),
        ("cain", "second", "1x4", 0), ("cain", "first", "2x2", 0),
        ("rrin", "second", "1x2a", R), ("sepconv", "second", "1x2a", 0),
        ("rrin", "first", "1x2a", 0), ("sepconv", "first", "1x2b", 0),
        ("superslomo", "first", "1x2b", R),
        ("superslomo", "second", "1x2b", 0)]
# the float32 runs held to JAX: SepConv's second order on 2 bands,
# VoxelFlow's on 4 with R = 8; their configs, frames and JAX programs are
# tests/test_torch_train_second_order.py's and tests/test_torch_warp_train
# .py's second-order config
JAX_RUNS = {"sepconv": "1x2b", "voxelflow": "1x4"}
JAX_CFG = {
    "sepconv": dict(model="sepconv", optimizer="Adamax", metasgd=True,
                    inner_lr=1e-5, outer_lr=1e-5, crop_size=32, batch_size=1,
                    mode="train", number_of_training_steps_per_iter=1,
                    second_order=True, loss="1*L1"),
    "voxelflow": dict(model="voxelflow", loss="1*MSE", optimizer="SGD",
                      metasgd=True, number_of_training_steps_per_iter=1,
                      inner_lr=1e-5, outer_lr=1e-5,
                      number_of_evaluation_steps_per_iter=1, crop_size=32,
                      mode="train", fast_warp_range=R, batch_size=1,
                      second_order=True)}
# the one-process runs: the rank of the run's mesh each runs on, beside its
# own banded result (their costs balanced; the rest on rank 3)
ONE_RANK = {RUNS[4]: 0, RUNS[5]: 1, RUNS[6]: 1, RUNS[7]: 2, RUNS[9]: 2}
TRAIN_RTOL = 1e-10
JAX_LOSS_RTOL, JAX_GRAD_RTOL, JAX_GRAD_ATOL = 1e-5, 1e-3, 1e-12
MESH_RANKS = {"1x4": [0, 1, 2, 3], "2x2": [0, 1, 2, 3], "1x2a": [0, 1],
              "1x2b": [2, 3]}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_id(run):
    return "-".join(str(v) for v in run)


def _config(run, mesh=None):
    """A float64 run's Config: the preset in training at one task (two
    on a 2x2 mesh), second order at the inner SGD rule and one inner
    step. SuperSloMo's first order takes the Super loss without its VGG16
    term (every rank computes the loss on the gathered frames); its second
    order the whole Super loss, whose perceptual term couples the rows of
    the gathered frames (the gather's double backward)."""
    model, order, shape, wr = run
    cfg = dict(PRESETS[model], inner_lr=1e-5, outer_lr=1e-5,
               number_of_evaluation_steps_per_iter=1, mode="train",
               fast_warp_range=wr, batch_size=2 if shape == "2x2" else 1)
    if order == "second":
        cfg.update(optimizer="SGD", second_order=True,
                   number_of_training_steps_per_iter=1)
    elif model == "superslomo":
        cfg["loss"] = "1*SuperNoPrcp"
    cfg.setdefault("number_of_training_steps_per_iter", 1)
    return Config(**cfg, device="cpu",
                  spatial_shards=mesh.spatial if mesh else 1)


def _grads(system, frames):
    """One iteration's outer loss and gradient (net and rates)."""
    loss, _, grads = system.outer_grads(frames, 0)
    return {"loss": float(loss),
            "grads": {g: {k: v.detach() for k, v in grads[g].items()}
                      for g in ("net", "lrs")}}


def _checksum(result):
    """A run's loss and, per group, the sum and the sum of squares of its
    outer gradient: the same on every rank of a mesh, whose all-reduce
    gives each the same gradient."""
    return (result["loss"],) + tuple(
        float(f(torch.cat([v.flatten() for v in result["grads"][g].values()])))
        for g in ("net", "lrs")
        for f in (torch.sum, lambda t: t.square().sum()))


def _against(got, want):
    """The banded result against the one process's: both losses, and each
    tensor's distance and the one process's norm."""
    return {"loss": (got["loss"], want["loss"]),
            "tensors": {(g, k): (float((got["grads"][g][k] - w).norm()),
                                 float(w.norm()))
                        for g in ("net", "lrs")
                        for k, w in want["grads"][g].items()}}


def _train64(run, mesh, frames):
    system = chip_smoke.to_float64(torch, SceneAdaptiveInterpolation(
        _config(run, mesh), mesh=mesh))
    return _grads(system, frames)


def _train_jax(model, mesh, inputs):
    """A float32 run with JAX's weights (JAX_CFG)."""
    system = SceneAdaptiveInterpolation(
        Config(**JAX_CFG[model], device="cpu", spatial_shards=mesh.spatial),
        mesh=mesh)
    bridge.load_jax_meta_params(system, inputs["trees"][model])
    return _grads(system, inputs["jax_frames"][model])


def _rank_cases(rank, work):
    """Every case, in one of the spawned ranks; what it computes is saved
    to ``work/rank<rank>.pt`` for the tests."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    work = pathlib.Path(work)
    mesh_lib.init_distributed("cpu")
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    meshes = {"1x4": mesh_lib.make_mesh("1x4"),
              "2x2": mesh_lib.make_mesh("2x2"),
              "1x2a": mesh_lib.make_mesh("1x2", ranks=[0, 1]),
              "1x2b": mesh_lib.make_mesh("1x2", ranks=[2, 3])}
    # each rank keeps its banded results, then saves their checksums, its
    # comparisons with the one process (ONE_RANK's runs) and, on a mesh's
    # first rank, a JAX run's gradient
    runs, out = {}, {"sums": {}, "one": {}, "jax": {}}
    # the runs of every rank first, then the two 1x2 meshes' at once
    for whole in (True, False):
        for run in RUNS:
            if (meshes[run[2]] is not None
                    and (len(MESH_RANKS[run[2]]) == RANKS) == whole):
                result = _train64(run, meshes[run[2]],
                                  inputs["frames"][run])
                out["sums"][run] = _checksum(result)
                if ONE_RANK.get(run, 3) == rank:
                    runs[run] = result
        for model, shape in JAX_RUNS.items():
            if (meshes[shape] is not None
                    and (len(MESH_RANKS[shape]) == RANKS) == whole):
                result = _train_jax(model, meshes[shape], inputs)
                out["sums"][model] = _checksum(result)
                if rank == MESH_RANKS[shape][0]:
                    out["jax"][model] = result
    for run in RUNS:
        if ONE_RANK.get(run, 3) == rank:
            out["one"][run] = _against(
                runs.pop(run), _train64(run, None, inputs["frames"][run]))
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def _jax_refs(systems, frames):
    """The JAX package's unsharded train steps: SepConv's second order as
    tests/test_torch_train_second_order.py compiles it (the same program,
    so the persistent compilation cache serves either file), VoxelFlow's
    op by op with its sweep jitted (tests/test_torch_warp_train.py)."""
    import jax
    import jax.numpy as jnp
    from meta_interpolation_tpu.meta import episode as jax_episode
    from test_torch_warp_train import jax_outer
    jsys = systems["sepconv"]
    spec = jsys._episode_spec("train", 1, True, False)
    msl_w = jnp.asarray(jax_episode.per_step_loss_importance(1, 0, 1))

    def outer(mp):
        return jsys.builder.task_episode(mp, jnp.asarray(frames["sepconv"][0]),
                                         msl_w, spec, training=True)[0]
    loss, grads = jax.jit(jax.value_and_grad(outer))(jsys.meta_params)
    refs = {"sepconv": (float(loss), jax.tree.map(np.asarray, grads))}
    loss, grads = jax_outer(systems["voxelflow"], frames["voxelflow"])
    refs["voxelflow"] = (loss, jax.tree.map(np.asarray, grads))
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
    frames = {run: rs.rand(2 if run[2] == "2x2" else 1, 7,
                           PRESETS[run[0]]["crop_size"],
                           PRESETS[run[0]]["crop_size"], 3).astype(np.float32)
              for run in RUNS}
    jax_frames = {model: np.asarray(SyntheticSeptuplet(
        model=model, mode="train", size=(32, 32))[0][0])[None]
        for model in JAX_RUNS}
    systems = {"sepconv": JaxSystem(JaxConfig(**JAX_CFG["sepconv"])),
               "voxelflow": JaxSystem(JaxConfig(**JAX_CFG["voxelflow"],
                                                jit_episode=False))}
    trees = {m: jax.tree.map(np.asarray, s.meta_params)
             for m, s in systems.items()}
    work = tmp_path_factory.mktemp("band_train")
    torch.save({"frames": frames, "jax_frames": jax_frames, "trees": trees},
               work / "inputs.pt")
    failed = []

    def run_ranks():
        try:
            spawn(_rank_cases, RANKS, args=(str(work),), timeout=600)
        except BaseException as e:  # re-raised after the runs here
            failed.append(e)
    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        refs = _jax_refs(systems, jax_frames)
    finally:
        thread.join()
    if failed:
        raise failed[0]
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(RANKS)]
    one = {run: rank["one"][run] for rank in got for run in rank["one"]}
    jax_runs = {model: rank["jax"][model] for rank in got
                for model in rank["jax"]}
    yield {"ranks": got, "jax": refs, "one": one, "jax_runs": jax_runs}
    shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("run", RUNS, ids=_run_id)
def test_sharded_training_matches_one_process_in_float64(ranks, run):
    """outer_grads on bands against one process: the loss and every
    tensor of the net's and the rates' outer gradients within 1e-10 (on a
    rank of the run's mesh; every rank of it with the same result); the
    bounded runs sample with K3, K3-grad and, in second order, K3-grad²'s
    plain versions on each band, the exact ones with the exact sampler's
    double backward on a band's grid rows."""
    case = ranks["one"][run]
    got, want = case["loss"]
    assert abs(got - want) <= TRAIN_RTOL * abs(want)
    for (g, k), (err, norm) in case["tensors"].items():
        assert err <= TRAIN_RTOL * norm, (g, k, err, norm)
    assert any(norm > 0 for (g, _), (_, norm) in case["tensors"].items()
               if g == "net")
    sums = [ranks["ranks"][r]["sums"][run] for r in MESH_RANKS[run[2]]]
    assert all(s == sums[0] for s in sums)


def _hold_to_jax(got, want_loss, want, model, per_group):
    assert abs(got["loss"] - want_loss) <= JAX_LOSS_RTOL * abs(want_loss)
    for g in ("net", "lrs"):
        ref = {k: v for k, v in bridge.params_from_jax(want[g],
                                                       model).items()
               if k in got["grads"][g]}
        pairs = [(k, got["grads"][g][k], v) for k, v in ref.items()]
        if per_group:
            pairs = [(g, torch.cat([a.flatten() for _, a, _ in pairs]),
                      torch.cat([b.flatten() for _, _, b in pairs]))]
        assert pairs and any(float(b.norm()) > 0 for _, _, b in pairs), g
        for name, a, b in pairs:
            err = float((a - b).norm())
            assert err <= JAX_GRAD_RTOL * float(b.norm()) + JAX_GRAD_ATOL, (
                g, name, err, float(b.norm()))


@pytest.mark.parametrize("model", list(JAX_RUNS))
def test_sharded_second_order_training_matches_jax(ranks, model):
    """The slice against JAX's unsharded train step: SepConv's second
    order on 2 bands (inner Adamax: each group's gradient within 1e-3 of
    its norm), VoxelFlow's on 4 bands with R = 8 (inner SGD: each
    tensor's); the loss within 1e-5; every rank of the mesh with the same
    result."""
    want_loss, want = ranks["jax"][model]
    net = SceneAdaptiveInterpolation(Config(**JAX_CFG[model],
                                            device="cpu")).model
    _hold_to_jax(ranks["jax_runs"][model], want_loss, want, net,
                 per_group=model == "sepconv")
    sums = [ranks["ranks"][r]["sums"][model]
            for r in MESH_RANKS[JAX_RUNS[model]]]
    assert all(s == sums[0] for s in sums)
