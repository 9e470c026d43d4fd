"""MegaDepth HourGlass depth network, interpreted from its JSON op tree.

Counterpart of ``meta_interpolation_tpu/models/dain/hourglass.py``. The
reference's machine-generated torch graph was captured once as
``hourglass_spec.json`` (copied here): a tree of {conv, bn, relu, maxpool,
avgpool, upsample, seq, parallel, reduce(cat|add)} nodes, 156 convs and
155 batch norms. :func:`build` turns it into modules whose names are the
tree's numeric indices, so ``depthNet.0.1.…`` joins the JAX parameter tree
and the reference state dict by name:

  * every child of a seq, parallel or reduce takes its index, parameter-free
    ones included (the JAX tree leaves their empty dicts out, and a module
    without parameters has no state-dict entry either);
  * a reduce with no children consumes the list that the parallel before
    it returned.

Batch norm is eval-mode (``layers.EvalBatchNorm2d``): DAIN freezes the
depth net, and its stored statistics are what the released weights hold.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .. import layers

_SPEC_PATH = Path(__file__).with_name("hourglass_spec.json")


@functools.cache
def spec() -> Dict[str, Any]:
    with open(_SPEC_PATH) as f:
        return json.load(f)


class Parallel(nn.ModuleList):
    """Every child on the same input → the list of their outputs."""

    def forward(self, x):
        return [m(x) for m in self]


class Reduce(nn.ModuleList):
    """Concatenate (channels) or add the children's outputs, or, with no
    children, the list it is given."""

    def __init__(self, fn: str, mods: List[nn.Module]):
        super().__init__(mods)
        self.fn = fn

    def forward(self, x):
        outs = [m(x) for m in self] if len(self) else x
        if self.fn == "cat":
            return torch.cat(outs, 1)
        acc = outs[0]
        for o in outs[1:]:
            acc = acc + o
        return acc


def _node(node: Dict[str, Any], gen: Optional[torch.Generator]) -> nn.Module:
    op = node["op"]
    if op == "conv":
        conv = nn.Conv2d(node["in"], node["out"], tuple(node["k"]),
                         stride=tuple(node["s"]), padding=tuple(node["p"]),
                         bias=node.get("bias", True))
        # the reference leaves the depth net at nn.Conv2d's own init
        return layers.torch_default_init_(conv, gen)
    if op == "bn":
        return layers.EvalBatchNorm2d(node["ch"], node["affine"],
                                      node.get("eps", 1e-5))
    if op == "relu":
        return nn.ReLU()
    if op in ("maxpool", "avgpool"):
        k = node["k"]
        k = k[0] if isinstance(k, list) else k
        return nn.MaxPool2d(k) if op == "maxpool" else nn.AvgPool2d(k)
    if op == "upsample":
        if node["mode"] != "nearest":
            raise ValueError(f"hourglass upsample mode {node['mode']!r}")
        return nn.Upsample(scale_factor=int(node["scale"]), mode="nearest")
    mods = [_node(child, gen) for child in node["mods"]]
    if op == "seq":
        return nn.Sequential(*mods)
    if op == "parallel":
        return Parallel(mods)
    if op == "reduce":
        return Reduce(node["fn"], mods)
    raise ValueError(f"unknown hourglass op {op!r}")


def build(generator: Optional[torch.Generator] = None) -> nn.Module:
    """The depth net: (N, 3, H, W) → (N, 1, H, W) log depth."""
    return _node(spec(), generator)
