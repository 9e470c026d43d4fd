"""The port's Python-file configs (utils/pyconfig.py) held against the JAX
package's: the same file read into the same settings, laid over each
package's Config with the same result."""
import dataclasses
import textwrap

import pytest

from meta_interpolation_tpu.config import Config as JaxConfig
from meta_interpolation_tpu.utils import pyconfig as jax_pyconfig
from meta_interpolation_tpu_torch.config import Config
from meta_interpolation_tpu_torch.utils.pyconfig import (AttrDict,
                                                         load_pyconfig,
                                                         merge_into_config)


@pytest.fixture
def cfg_file(tmp_path):
    path = tmp_path / "voxelflow_maml_config.py"
    path.write_text(textwrap.dedent("""
        import os
        MODEL = "voxelflow"
        LOSS = "1*MSE"
        BATCH_SIZE = 4
        INNER_LR = 2e-5
        REMAT = True
        SOME_UNKNOWN_SETTING = 42
        scratch = os.sep
        _PRIVATE = 1
    """))
    return str(path)


def test_load_and_merge_match_jax(cfg_file, capsys):
    got = load_pyconfig(cfg_file)
    want = jax_pyconfig.load_pyconfig(cfg_file)
    assert dict(got) == dict(want)
    assert got.model == "voxelflow" and "scratch" not in got
    merged = merge_into_config(Config(), got)
    assert "ignoring unknown keys: ['some_unknown_setting']" in (
        capsys.readouterr().out)
    jmerged = jax_pyconfig.merge_into_config(JaxConfig(), want)
    for f in dataclasses.fields(Config):
        if hasattr(jmerged, f.name):
            assert getattr(merged, f.name) == getattr(jmerged, f.name), (
                f.name)
    assert merged.remat and merged.batch_size == 4
    assert merged.outer_lr == Config().outer_lr and merged.device == "cuda"


def test_attrdict():
    d = AttrDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    with pytest.raises(AttributeError):
        _ = d.missing
