"""Python-file configs (VoxelFlow's config subsystem).

Counterpart of ``meta_interpolation_tpu/utils/pyconfig.py`` (reference
``voxelflow/core/utils/config.py:10-60``): a Python module's UPPERCASE
settings, read into an attribute dict, and laid over a :class:`Config`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from typing import Any, Dict

from ..config import Config


class AttrDict(dict):
    """A dict whose keys read and write as attributes (easydict)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def load_pyconfig(path: str) -> AttrDict:
    """The module-level UPPERCASE names of the Python file ``path``,
    lower-cased; other names (imports, scratch variables) are not
    settings."""
    spec = importlib.util.spec_from_file_location("user_config", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = AttrDict()
    for name in dir(mod):
        if not name.startswith("_") and name.isupper():
            out[name.lower()] = getattr(mod, name)
    return out


def merge_into_config(cfg: Config, pycfg: Dict[str, Any]) -> Config:
    """``cfg`` with the settings of ``pycfg`` that name a Config field; the
    others are reported and ignored."""
    known = {f.name for f in dataclasses.fields(Config)}
    updates = {k: v for k, v in pycfg.items() if k in known}
    unknown = sorted(set(pycfg) - known)
    if unknown:
        print(f"[pyconfig] ignoring unknown keys: {unknown}")
    return dataclasses.replace(cfg, **updates)
