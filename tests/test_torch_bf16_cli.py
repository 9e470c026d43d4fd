"""The port's CLI under --dtype bfloat16 held on the CPU against the JAX
package's, on the tiny CAIN of tests/test_torch_test_mode.py (both start
from one JAX init): ×2 slow motion (``--mode test``), whose frames are
written from the float32 prediction, and scene-adaptive evaluation
(``--mode val``, its predictions written by --viz). Training under bf16
runs in tests/test_torch_warp_models_episode.py and
tests/test_torch_superslomo_episode.py (``train_bf16_on_the_cpu``).

Rule, bf16 itself: the port's bf16 frames within twice the JAX bf16 run's
largest difference from its own float32 run, plus one 8-bit level.
"""
import numpy as np
import pytest

from meta_interpolation_tpu.main import main as jax_main
from meta_interpolation_tpu_torch.main import main
from test_torch_test_mode import (  # noqa: F401 (fixtures)
    CROP, TINY_CAIN, _cli, _frames, _written, pth, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")


def _jax(dtype):
    return lambda argv: jax_main(argv + ["--dtype", dtype])


def _port_bf16(argv):
    return main(argv + ["--dtype", "bfloat16", "--device", "cpu"])


def test_cli_test_mode_in_bf16_writes_what_jax_writes(tmp_path, pth):
    runs = {"jax_f32": _jax("float32"), "jax_bf16": _jax("bfloat16"),
            "port_bf16": _port_bf16}
    written, counts = {}, {}
    for name, run in runs.items():
        root = _frames(str(tmp_path / name))
        counts[name] = _cli(run, root, tmp_path / f"{name}_ckpt", pth)
        written[name] = _written(root)
    assert counts["port_bf16"] == counts["jax_bf16"] == 3
    assert sorted(written["port_bf16"]) == sorted(written["jax_bf16"])
    for frame, want in written["jax_bf16"].items():
        gap = np.abs(want - written["jax_f32"][frame]).max()
        err = np.abs(written["port_bf16"][frame] - want).max()
        assert err <= 2 * gap + 1, (frame, err, gap)


def test_cli_val_in_bf16_matches_jax(tmp_path, pth):
    """The 8 synthetic clips with --viz: each clip's written prediction
    held to JAX's by the frames' rule (the mean PSNR of 8 clips averages
    bf16's rounding away, so it is only required finite)."""
    argv = TINY_CAIN + ["--pretrained_model", str(pth), "--mode", "val",
                        "--dataset", "synthetic", "--crop_size", str(CROP),
                        "--number_of_evaluation_steps_per_iter", "1",
                        "--optimizer", "Adam", "--metasgd", "--inner_lr",
                        "1e-5", "--loss", "1*L1", "--viz"]
    written = {}
    for name, run in (("jax_f32", _jax("float32")),
                      ("jax_bf16", _jax("bfloat16")),
                      ("port_bf16", _port_bf16)):
        stats = run(argv + ["--checkpoint_dir", str(tmp_path / name)])
        assert np.isfinite(stats["psnr"])
        written[name] = _written(tmp_path / name / "exp" / "synthetic")
    assert sorted(written["port_bf16"]) == sorted(written["jax_bf16"])
    assert len(written["port_bf16"]) == 8
    for frame, want in written["jax_bf16"].items():
        gap = np.abs(want - written["jax_f32"][frame]).max()
        err = np.abs(written["port_bf16"][frame] - want).max()
        assert err <= 2 * gap + 1, (frame, err, gap)
