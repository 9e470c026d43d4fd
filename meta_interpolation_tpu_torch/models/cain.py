"""CAIN — Channel Attention Is All You Need for video frame interpolation.

Counterpart of ``meta_interpolation_tpu/models/cain.py`` (reference
``cain/model.py:10-118`` and ``model_utils.py:931-1053``): both frames
lose their per-channel mean, are reflect-padded to a ×128 grid and
shuffled ×1/8 from space to depth (3 → 192 channels at depth 3); the
concatenated pair runs a head conv, 5 residual groups of 12 RCABs
(reflect-pad 3×3 conv, LeakyReLU 0.2, 3×3 conv, channel attention with
reduction 16) and a tail conv each, and a tail conv; the result is
shuffled ×8 back, cropped, and the mean of the two frames' means added.
Only 3×3 and 1×1 convolutions (cuDNN): no kernel of the port's own.

In a row shard (``parallel/spatial.row_shard``, the exact
``--spatial_shards`` evaluation) every rank prepares the whole frames
(the means, the apron, the grid pad and the space-to-depth shuffle), takes
its band of the shuffled rows, runs the body on it (row-aware convs and
channel-attention means, ``models/layers.py``) and gathers the bands
before the crop.

Module names follow the reference state dict and the JAX tree
(``encoder.interpolate.body.{g}.body.{b}.body.0.conv.weight``, …), so
``core/checkpoint.params_from_jax`` bridges it unchanged.

The JAX package's ``pack`` and ``packed_body`` restack the body weights
for its ``lax.scan`` and compute nothing of their own; the loops here
read the weights in place, so they have no counterpart.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import spatial
from . import layers

# a conv's border handling (--fuse_pad, --fuse_groups): False the exact
# reflect pad, True zero padding, "reflect" the exact math again (JAX
# restructures it for XLA as a zero-padded conv with border corrections,
# layers.conv2d_reflect3x3; here it is the reflect pad itself)
Mode = Union[bool, str]


class ConvNorm(nn.Module):
    """Reflect-pad k×k conv (reference MetaConvNorm, model_utils.py
    :821-848) in one of the border modes above."""

    def __init__(self, in_ch: int, out_ch: int, k: int, mode: Mode = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = layers.xavier_conv(in_ch, out_ch, k, generator)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.conv.kernel_size[0] // 2
        if spatial.current() is not None:
            return layers.band_conv(x, self.conv.weight, self.conv.bias,
                                    pad, reflect=self.mode is not True)
        if self.mode is True:
            return F.conv2d(x, self.conv.weight, self.conv.bias, padding=pad)
        # the body's maps are wider than one pixel, so F.pad's reflection
        # is jnp.pad's
        x = layers.reflect_pad_same(x, pad)
        return F.conv2d(x, self.conv.weight, self.conv.bias)


class CALayer(nn.Module):
    """Channel attention: global mean, 1×1 down, ReLU, 1×1 up, sigmoid,
    times the input."""

    def __init__(self, ch: int, reduction: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_du = nn.Sequential(
            layers.xavier_conv(ch, ch // reduction, 1, generator), nn.ReLU(),
            layers.xavier_conv(ch // reduction, ch, 1, generator),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(layers.global_avg_pool(x))


class RCAB(nn.Module):
    """Residual channel-attention block; both convs in one mode."""

    def __init__(self, ch: int, reduction: int, mode: Mode,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.body = nn.Sequential(
            ConvNorm(ch, ch, 3, mode, generator), nn.LeakyReLU(0.2),
            ConvNorm(ch, ch, 3, mode, generator),
            CALayer(ch, reduction, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class ResidualGroup(nn.Module):
    """``n_resblocks`` RCABs and a tail conv, plus the skip; ``modes`` has
    an entry for each RCAB and a last one for the tail conv."""

    def __init__(self, ch: int, reduction: int, modes: Sequence[Mode],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        *rcabs, tail = modes
        self.body = nn.Sequential(
            *[RCAB(ch, reduction, m, generator) for m in rcabs],
            ConvNorm(ch, ch, 3, tail, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class Interpolation(nn.Module):
    """Head conv, the residual groups, the long skip, the tail conv."""

    def __init__(self, ch: int, group_modes: List[List[Mode]],
                 reduction: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.headConv = layers.xavier_conv(ch * 2, ch, 3, generator)
        self.body = nn.Sequential(*[
            ResidualGroup(ch, reduction, modes, generator)
            for modes in group_modes])
        self.tailConv = layers.xavier_conv(ch, ch, 3, generator)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        x = self.headConv(torch.cat([x0, x1], dim=1))
        return self.tailConv(self.body(x) + x)


def boundary_fuse(first_blocks: int = 1, all_groups: bool = False,
                  n_resgroups: int = 5, n_resblocks: int = 12):
    """The serving operating point of JAX ``cain.boundary_fuse``: the
    first ``first_blocks`` RCABs of group 0 (of every group with
    ``all_groups``) in "reflect", the rest of the body zero-padded."""
    blockwise = (["reflect"] * first_blocks
                 + [True] * (n_resblocks + 1 - first_blocks))
    if all_groups:
        return [list(blockwise) for _ in range(n_resgroups)]
    return [blockwise] + [True] * (n_resgroups - 1)


def parse_fuse_spec(spec: str, n_resgroups: int = 5, n_resblocks: int = 12):
    """A ``--fuse_groups`` token → the model's ``fuse_pad`` (JAX
    ``cain.parse_fuse_spec``): ``exact``/``false`` → False, ``zero``/
    ``true`` → True, ``reflect``; a letter a residual group over R
    (reflect), Z (zero) and X (exact), e.g. ``RZZZZ``; ``bwJ`` →
    :func:`boundary_fuse` (J); ``bwJxG`` with G = n_resgroups → the same in
    every group. Anything else raises ValueError."""
    low = spec.lower()
    if low in ("exact", "false"):
        return False
    if low in ("zero", "true"):
        return True
    if low == "reflect":
        return "reflect"
    m = re.fullmatch(r"bw(\d+)(?:x(\d+))?", low)
    if m:
        j = int(m.group(1))
        if not 1 <= j <= n_resblocks:
            raise ValueError(f"--fuse_groups {spec!r}: bwJ needs "
                             f"1 <= J <= {n_resblocks}")
        if m.group(2) is not None:
            if int(m.group(2)) != n_resgroups:
                raise ValueError(
                    f"--fuse_groups {spec!r}: bwJxG supports only "
                    f"G == n_resgroups ({n_resgroups})")
            return boundary_fuse(j, all_groups=True,
                                 n_resgroups=n_resgroups,
                                 n_resblocks=n_resblocks)
        return boundary_fuse(j, n_resgroups=n_resgroups,
                             n_resblocks=n_resblocks)
    letters = {"R": "reflect", "Z": True, "X": False}
    if all(c in letters for c in spec):
        if len(spec) != n_resgroups:
            raise ValueError(
                f"--fuse_groups {spec!r}: per-group letter strings need "
                f"exactly {n_resgroups} letters (one per residual group)")
        return [letters[c] for c in spec]
    raise ValueError(
        f"--fuse_groups {spec!r}: expected exact|zero|reflect, an R/Z/X "
        f"letter string of length {n_resgroups}, bwJ, or bwJx{n_resgroups}")


def group_modes(fuse_pad, n_resgroups: int, n_resblocks: int
                ) -> List[List[Mode]]:
    """``fuse_pad`` (one mode, or a list with a mode or a list of
    n_resblocks + 1 modes for each group) → each group's n_resblocks + 1
    modes, the last its tail conv's (JAX ``cain._interpolation``)."""
    if not isinstance(fuse_pad, (list, tuple)):
        fuse_pad = [fuse_pad] * n_resgroups
    if len(fuse_pad) != n_resgroups:
        raise ValueError(f"fuse_pad has {len(fuse_pad)} entries for "
                         f"{n_resgroups} residual groups")
    out = []
    for entry in fuse_pad:
        modes = (list(entry) if isinstance(entry, (list, tuple))
                 else [entry] * (n_resblocks + 1))
        if len(modes) != n_resblocks + 1:
            raise ValueError(f"a group's fuse modes need {n_resblocks + 1} "
                             f"entries (the RCABs and the tail conv), got "
                             f"{len(modes)}")
        out.append(modes)
    return out


class CAIN(nn.Module):
    """``forward(frame0, frame1)``: NCHW frames in [0, 1] → the middle
    frame, NCHW.

    ``pad_multiple`` 128 is the reference's grid; the architecture needs
    only 2**depth, which changes what the convs see at the border.
    ``fuse_pad``: the body convs' border mode, one for all, or one per
    residual group, or per RCAB within a group (:func:`group_modes`).
    ``apron``: reflect-pad the input by this many pixels before the grid
    pad, and crop after."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 depth: int = 3, n_resgroups: int = 5, n_resblocks: int = 12,
                 reduction: int = 16, pad_multiple: int = 128,
                 fuse_pad=False, apron: int = 0):
        super().__init__()
        ch = 3 * 4 ** depth
        if ch // reduction < 1:
            raise ValueError(
                f"channel attention reduction {reduction} exceeds {ch} "
                f"channels at depth={depth}; lower --depth or pass a smaller "
                f"reduction")
        self.depth = depth
        self.pad_multiple = pad_multiple
        self.apron = apron
        self.encoder = nn.ModuleDict({"interpolate": Interpolation(
            ch, group_modes(fuse_pad, n_resgroups, n_resblocks), reduction,
            generator)})

    def row_bands(self, h: int, shards: int) -> bool:
        """Whether a frame of ``h`` rows runs exactly in ``shards`` row
        bands: its shuffled grid splits into equal bands of at least 2
        rows (a reflected border row comes from the band's own rows)."""
        rows = h + 2 * self.apron
        rows = (rows + (-rows) % self.pad_multiple) // 2 ** self.depth
        return rows % shards == 0 and rows // shards >= 2

    def forward(self, frame0: torch.Tensor, frame1: torch.Tensor
                ) -> torch.Tensor:
        layers.full_float32()
        x0, m0 = layers.sub_mean(frame0)
        x1, m1 = layers.sub_mean(frame1)
        if self.apron:
            x0 = layers.reflect_pad(x0, self.apron)
            x1 = layers.reflect_pad(x1, self.apron)
        x0, pads = layers.pad_to_multiple(x0, self.pad_multiple)
        x1, _ = layers.pad_to_multiple(x1, self.pad_multiple)
        s = 2 ** self.depth
        x0, x1 = (layers.pixel_shuffle(x, 1 / s) for x in (x0, x1))
        shard = spatial.current()
        if shard is not None:
            x0, x1 = spatial.band(x0, shard), spatial.band(x1, shard)
        out = layers.pixel_shuffle(self.encoder["interpolate"](x0, x1), s)
        if shard is not None:
            out = spatial.gather_band(out, shard)
        out = layers.unpad(out, pads)
        if self.apron:
            a = self.apron
            out = out[..., a:-a, a:-a]
        return out + (m0 + m1) / 2.0
