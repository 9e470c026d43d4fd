"""Config / flag system.

The port's own copy of ``meta_interpolation_tpu/config.py``: the same
dataclass and the same flags, so command lines carry over unchanged, plus
``--device {cuda,cpu}``. Flags of the JAX package's TPU group that steer
its compilation or sharding (``--mesh_shape``, ``--episode_parallel``,
``--jit_episode``) are accepted and have no effect here; ``--remat``
recomputes each model forward in its backward
(``torch.utils.checkpoint``); ``--spatial_shards`` above 1 raises.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # Dataset (reference config.py:14-20)
    dataset: str = "vimeo90k"
    num_frames: int = 3
    data_root: str = "data/vimeo_septuplet"
    img_fmt: str = "png"
    fps: int = 30

    # Model (reference config.py:22-27)
    model: str = "cain"
    depth: int = 3
    n_resblocks: int = 12
    up_mode: str = "shuffle"

    # Learning (reference config.py:29-63)
    mode: str = "train"  # train | val | test
    loss: str = "1*L1"
    optimizer: str = "Adam"  # Adam | Adamax | SGD (outer AND inner rule family)
    inner_lr: float = 1e-5
    outer_lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 1e-4
    batch_size: int = 8
    val_batch_size: int = 1
    test_batch_size: int = 1
    test_mode: str = "hard"
    start_epoch: int = 0
    max_epoch: int = 60
    resume: bool = False
    resume_exp: Optional[str] = None
    pretrained_model: Optional[str] = None
    fix_loaded: bool = False
    number_of_training_steps_per_iter: int = 1
    number_of_evaluation_steps_per_iter: int = 1
    learnable_per_layer_per_step_inner_loop_learning_rate: bool = False
    enable_inner_loop_optimizable_bn_params: bool = False
    # per-step BN running statistics (reference MetaBatchNormLayer with
    # use_per_step_bn_statistics, model_utils.py:453-461,504-521): BN runs
    # in train mode — batch-stat normalization, per-step running rows
    # updated on every forward — with the state threaded through the
    # episode; persisted across iterations at train, discarded per task
    # at eval/test (restore_backup_stats, meta_learning_system.py:463-464).
    # Opt-in: no reference preset reaches this layer mode (the backbones'
    # own BN is frozen); models must provide ModelDef.bn_state_init_fn
    # (voxelflow). Composes with
    # --enable_inner_loop_optimizable_bn_params (adaptable flat affine).
    per_step_bn_statistics: bool = False
    second_order: bool = False
    first_order_to_second_order_epoch: int = -1
    use_multi_step_loss_optimization: bool = False
    multi_step_loss_num_epochs: int = 1
    total_iter_per_epoch: int = 10
    attenuate: bool = False  # L2F attenuation
    metasgd: bool = False  # Meta-SGD per-parameter learnable LRs

    # Misc (reference config.py:65-77)
    exp_name: str = "exp"
    log_iter: int = 20
    log_dir: str = "logs"
    eval_iter: int = 10
    data_dir: str = "data"
    random_seed: int = 12345
    # decorative, as in the reference (config.py:72 — only toggles
    # args.cuda there; no multi-GPU path exists, SURVEY.md §2.5). Device
    # count here comes from the visible TPU mesh / --mesh_shape.
    num_gpu: int = 1
    num_workers: int = 5
    use_tensorboard: bool = False
    viz: bool = False
    lpips: bool = False

    # --- TPU-native additions (no reference equivalent; SURVEY.md §2.5) ---
    mesh_shape: Optional[str] = None  # e.g. "4" or "2x4"; None = all devices, 1D
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    episode_parallel: bool = True  # shard the task axis over the mesh
    spatial_shards: int = 1  # spatial (H) sharding for HD eval
    checkpoint_dir: str = "checkpoint"
    crop_size: int = 256
    jit_episode: bool = True
    # torch.profiler trace of the whole run (utils/profiling.trace)
    profile_dir: Optional[str] = None
    # bounded fast warp for flow models (0 = exact gather; >0 = pixel bound,
    # inference-quality path — see ops/warp.grid_sample_bounded)
    fast_warp_range: int = 0
    # recompute each model forward's activations in its backward
    # (torch.utils.checkpoint): trades FLOPs for device memory
    remat: bool = False
    # CAIN input padding granularity. 128 = reference-exact
    # (model_utils.py:17-28); the architecture only needs 2**depth, so 8
    # skips all padding when H,W are /8-divisible (448x256: -12.5% FLOPs).
    # Changes conv boundary context vs the reference — validate PSNR on
    # your checkpoint before serving with it.
    pad_multiple: int = 128
    # CAIN body-conv reflect-pad handling: "false" = reference-exact
    # materialized reflect pads; "reflect" = same math restructured as a
    # zero-SAME conv + analytic border corrections (no extra HBM traffic,
    # fp-reassociated only — layers.conv2d_reflect3x3); "true" = serving
    # approximation, plain zero SAME padding (boundary context changes —
    # validate on a trained checkpoint, see models/cain._conv_norm).
    fuse_pad: str = "false"
    # CAIN per-group / RCAB-granular serving graph (overrides --fuse_pad
    # when set): "RZZZZ"-style per-residual-group letter strings
    # (R=reflect, Z=zero-fuse, X=exact), "bwJ"/"bwJx5" boundary-fuse
    # points (reflect the first J RCABs — models/cain.parse_fuse_spec),
    # or exact|zero|reflect. Gives the measured serving Pareto points a
    # first-class CLI surface; the token is recorded in checkpoint arch
    # so graph-specific checkpoints are self-describing.
    fuse_groups: Optional[str] = None
    # GAN discriminator update cadence. Default (False): one update per
    # outer iteration on the query preds. True: reference cadence — the
    # reference updates D inside EVERY criterion call (loss.py:168-213 —
    # per support pair x inner step, plus the query; while MSL is active,
    # also each step's query criterion), a ~(2k+1)x higher D/G update
    # ratio. The episode collects the per-step support predictions (and,
    # under MSL, the per-step query predictions) so the system replays
    # every criterion call's D update in episode order.
    disc_per_forward: bool = False
    # second-order inner-grad convs as pure tap-einsums (no grouped convs
    # in the double-backward; outer grads bit-equivalent — pinned by
    # test). Opt-in: at full CAIN size the tap-slice residuals fragment
    # HBM (measured OOM at bs4 crop 256); viable at smaller crops/batches.
    second_order_einsum: bool = False
    # where the port runs: "cuda" (the hand-written kernels) or "cpu" (their
    # plain PyTorch versions); never switched silently
    device: str = "cuda"

    @property
    def fuse_pad_mode(self):
        """--fuse_pad as the cain.apply kwarg: False | True | 'reflect'."""
        v = str(self.fuse_pad).lower()
        if v in ("false", "0", "no"):
            return False
        if v in ("true", "1", "yes"):
            return True
        if v == "reflect":
            return "reflect"
        raise ValueError(f"--fuse_pad must be true/false/reflect, got "
                         f"{self.fuse_pad!r}")

    @property
    def num_inner_steps(self) -> int:
        return self.number_of_training_steps_per_iter

    @property
    def num_eval_steps(self) -> int:
        return self.number_of_evaluation_steps_per_iter

    def support_idxs(self, mode: Optional[str] = None) -> Tuple[Tuple[int, int, int], ...]:
        """Support triplets (in0, target, in1) per task.

        Reference meta_learning_system.py:43-46: 7-frame septuplets use
        [[0,2,4],[2,4,6]]; test mode (4 consecutive frames) uses
        [[0,1,2],[1,2,3]].
        """
        mode = mode or self.mode
        if mode == "test":
            return ((0, 1, 2), (1, 2, 3))
        return ((0, 2, 4), (2, 4, 6))

    target_idxs: Tuple[int, int, int] = (2, 3, 4)


_BOOL_FLAGS = {
    "resume", "fix_loaded",
    "learnable_per_layer_per_step_inner_loop_learning_rate",
    "enable_inner_loop_optimizable_bn_params", "per_step_bn_statistics",
    "second_order",
    "use_multi_step_loss_optimization", "attenuate", "metasgd",
    "use_tensorboard", "viz", "lpips", "remat", "disc_per_forward",
    "second_order_einsum",
}


_HELP = {
    "model": "backbone: cain (default), sepconv, rrin, dain, superslomo or "
             "voxelflow; each meta-trains (--mode train, first or "
             "--second_order) and evaluates. "
             "dain adapts and trains only its rectify net, on its own "
             "charbonnier loss whatever --loss says and projects flows "
             "exactly; random weights need a tamed depth head "
             "(models/dain/model.tame_depth_head_). superslomo takes "
             "--loss 1*Super (VGG16 features) or 1*SuperNoPrcp",
    "mode": "train, val (scene-adaptive evaluation) or test (x2 slow "
            "motion: writes name_<mean index>.<img_fmt> beside each pair "
            "of a --dataset test frame directory; run again for x4)",
    "viz": "--mode val: write each prediction under "
           "<checkpoint_dir>/<exp_name>/<dataset>",
    "fuse_pad": "cain: the body convs' border: false (the reference's "
                "reflect pad), true (zero padding) or reflect (the same "
                "math as false)",
    "fuse_groups": "cain: a border mode per residual group (R/Z/X letters, "
                   "e.g. RZZZZ), bwJ or bwJx5 (the first J blocks in "
                   "reflect, the rest zero), or exact|zero|reflect; "
                   "overrides --fuse_pad",
    "fast_warp_range": "bounded warp for rrin, superslomo and voxelflow "
                       "(0 = the exact sampler)",
    "enable_inner_loop_optimizable_bn_params":
        "adapt the batch-norm scale and bias in the inner loop too "
        "(voxelflow); the statistics stay frozen",
    "device": "cuda (the hand-written kernels) or cpu (their plain "
              "PyTorch versions)",
}


def _strict_bool(v: str) -> bool:
    """true/false parser that REJECTS unknown tokens — a permissive
    'v in ("true","1")' would turn a typo like '--jit_episode ture' into
    a silent False (episodes running uncompiled)."""
    lv = v.lower()
    if lv in ("true", "1", "yes"):
        return True
    if lv in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Scene-adaptive video frame interpolation (PyTorch)")
    for field in dataclasses.fields(Config):
        if field.name in ("target_idxs",):
            continue
        name = "--" + field.name
        default = field.default
        kw = {"default": default, "help": _HELP.get(field.name)}
        if field.name in _BOOL_FLAGS:
            parser.add_argument(name, action="store_true", **kw)
        elif field.name == "episode_parallel" or field.name == "jit_episode":
            parser.add_argument(name, type=_strict_bool, **kw)
        elif field.name == "device":
            parser.add_argument(name, choices=("cuda", "cpu"), **kw)
        elif field.type in ("Optional[str]",):
            parser.add_argument(name, type=str, **kw)
        elif isinstance(default, bool):
            parser.add_argument(name, action="store_true", **kw)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, **kw)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, **kw)
        else:
            parser.add_argument(name, type=str, **kw)
    return parser


def get_args(argv=None) -> Config:
    """Parse CLI args into a Config (reference config.py:79-89)."""
    parser = build_parser()
    args, unparsed = parser.parse_known_args(argv)
    if unparsed:
        print(f"Unparsed args: {unparsed}")
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in known})
