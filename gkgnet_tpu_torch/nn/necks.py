"""Necks over the backbone's end-of-stage maps (counterpart:
``gkgnet_tpu/nn/necks.py``; the reference's mmcls necks). Maps are NHWC;
a multi-scale input is a tuple, finest first.

  * ``GlobalAveragePooling``: the mean over H and W, ``(B, C)`` per map.
  * ``MultiLabelProjection``: per-class projectors after the mean,
    ``(B, num_classes, proj_channels)`` in fp32.
  * ``HRFuseScales``: each map 1x1-projected (no bias) to ``out_channels``,
    the coarser ones bilinearly upsampled to the finest grid, summed, then
    a 3x3 conv.
  * ``ChannelMapper``: a ``kernel_size`` conv per map.
  * ``FPN``: 1x1 lateral convs, a top-down path of nearest upsampling and
    sums, a 3x3 conv per level.

Unlike the JAX package's flax modules, which size their kernels from the
first input, each takes the channels of its input maps (``in_channels``,
one per map). Parameters are fp32, named after the JAX modules (``proj0``,
``fuse``, ``conv0``, ``lateral0``, ``fpn_conv0``; the projection's
``kernel`` and ``bias``), and cast to the compute dtype where they are
used.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class NHWCConv(nn.Module):
    """A stride-1 ``kernel_size`` convolution with SAME padding on NHWC
    maps; ``weight`` has the torch layout ``(Cout, Cin, kh, kw)``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ks = self.weight.shape[-1]
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), bias, padding=ks // 2)
        return y.permute(0, 2, 3, 1)


def _resize(x: torch.Tensor, hw: tuple[int, int], mode: str) -> torch.Tensor:
    """An NHWC map resized to ``hw``: 'bilinear' with half-pixel centres
    (``jax.image.resize``'s, whose upsampling weights at the border equal
    the clamped ones of ``align_corners=False``), 'nearest' as
    ``nearest-exact`` (the half-pixel nearest sample)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw,
                      mode="bilinear" if mode == "bilinear"
                      else "nearest-exact",
                      **({"align_corners": False} if mode == "bilinear"
                         else {}))
    return y.permute(0, 2, 3, 1)


class GlobalAveragePooling(nn.Module):
    """GAP over H and W: NHWC in, ``(B, C)`` out (a tuple for a tuple)."""

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            return tuple(xi.mean(dim=(1, 2)) for xi in x)
        return x.mean(dim=(1, 2))


class MultiLabelProjection(nn.Module):
    """One ``in_channels -> proj_channels`` projector per class after GAP:
    ``(B, num_classes, proj_channels)`` fp32."""

    def __init__(self, num_classes: int, in_channels: int,
                 proj_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(num_classes, in_channels, proj_channels))
        self.bias = nn.Parameter(torch.zeros(num_classes, proj_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            x = x.mean(dim=(1, 2))
        return torch.einsum("bc,ncp->bnp", x.float(), self.kernel) + self.bias


class HRFuseScales(nn.Module):
    """Fuse a pyramid into one map on the finest grid."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"proj{i}", NHWCConv(c, out_channels, 1, False,
                                                 dtype))
        self.fuse = NHWCConv(out_channels, out_channels, 3, True, dtype)

    def forward(self, xs) -> torch.Tensor:
        if not isinstance(xs, (tuple, list)):
            xs = (xs,)
        hw = tuple(xs[0].shape[1:3])
        fused = 0.0
        for i, x in enumerate(xs):
            x = getattr(self, f"proj{i}")(x)
            if tuple(x.shape[1:3]) != hw:
                x = _resize(x, hw, "bilinear")
            fused = fused + x
        return self.fuse(fused)


class ChannelMapper(nn.Module):
    """A ``kernel_size`` conv to ``out_channels`` per map."""

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 kernel_size: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"conv{i}", NHWCConv(c, out_channels,
                                                 kernel_size, True, dtype))

    def forward(self, xs):
        single = not isinstance(xs, (tuple, list))
        if single:
            xs = (xs,)
        out = tuple(getattr(self, f"conv{i}")(x) for i, x in enumerate(xs))
        return out[0] if single else out


class FPN(nn.Module):
    """A top-down feature pyramid: a tuple in, a tuple out, finest first."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", NHWCConv(c, out_channels, 1, True,
                                                    dtype))
        for i in range(len(in_channels)):
            self.add_module(f"fpn_conv{i}", NHWCConv(
                out_channels, out_channels, 3, True, dtype))

    def forward(self, xs):
        laterals = [getattr(self, f"lateral{i}")(x) for i, x in enumerate(xs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = _resize(laterals[i], tuple(laterals[i - 1].shape[1:3]),
                         "nearest")
            laterals[i - 1] = laterals[i - 1] + up
        return tuple(getattr(self, f"fpn_conv{i}")(lat)
                     for i, lat in enumerate(laterals))


NECKS = {
    "GlobalAveragePooling": GlobalAveragePooling,
    "MultiLabelProjection": MultiLabelProjection,
    "HRFuseScales": HRFuseScales,
    "ChannelMapper": ChannelMapper,
    "FPN": FPN,
}


def neck_out_channels(cfg: dict, in_channels: Sequence[int]) -> int:
    """The channels of the pooled output of a neck over maps of
    ``in_channels`` (the linear head's input; the JAX package's flax head
    reads it from its input): the last map's for GAP, ``proj_channels``
    for the projection, else ``out_channels``."""
    if cfg["type"] == "GlobalAveragePooling":
        return in_channels[-1]
    if cfg["type"] == "MultiLabelProjection":
        return cfg["proj_channels"]
    return cfg.get("out_channels", 256)


def build_neck(cfg: dict, in_channels: Sequence[int],
               dtype: torch.dtype = torch.float32) -> nn.Module:
    """A neck config (``type`` and the module's settings; ``out_indices``
    is the classifier's) -> the module, over maps of ``in_channels``."""
    cfg = dict(cfg)
    t = cfg.pop("type")
    cfg.pop("out_indices", None)
    if t not in NECKS:
        raise ValueError(f"unknown neck type {t}")
    if t == "GlobalAveragePooling":
        # parameterless; out_channels in the cfg only sizes the head
        return GlobalAveragePooling()
    cfg.pop("dtype", None)
    if t == "MultiLabelProjection":
        return MultiLabelProjection(dtype=dtype, **cfg)
    return NECKS[t](in_channels=list(in_channels), dtype=dtype, **cfg)
