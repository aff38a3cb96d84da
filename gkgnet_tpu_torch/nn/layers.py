"""Basic layers, channel-last (counterpart: ``gkgnet_tpu/nn/layers.py``).

Parameters are held in fp32 with the reference's mmcls names and torch
layouts (conv weights ``(Cout, Cin/groups, kh, kw)``), and cast to the
compute dtype where they are used, as the JAX package does. Weights are
created empty; ``gkgnet_tpu_torch.nn.classifier.init_parameters`` fills them
from a seeded generator.

  * ``BatchNorm``: normalization computed in fp32 and cast back to the
    compute dtype; in train mode (``module.training``) with the batch
    moments, updating the running statistics in place.
  * ``PointwiseConv``: 1x1 (grouped) convolution over the last axis as a
    matmul; ``BasicConv`` uses groups=4.
  * ``Activation``: relu, exact-erf GELU, leakyrelu, prelu (a learned
    fp32 slope ``weight`` of shape (1,), torch ``nn.PReLU``'s name) and
    hswish.
  * ``Stem``/``Downsample``: 3x3 convolutions on NHWC tensors.
  * ``DropPath``: per-sample stochastic depth on a residual branch, drawn
    from a ``torch.Generator`` the caller passes in.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch normalization over all axes but the last. In train mode it
    normalizes with the biased batch variance ``mean(x^2) - mean(x)^2``
    (clamped at 0, in fp32, as the JAX package computes it) and moves the
    running statistics by momentum 0.1 towards the batch mean and the
    unbiased batch variance; in eval mode it uses the running statistics."""

    momentum = 0.1

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x32.mean(dim=axes)
            var = torch.clamp(x32.square().mean(dim=axes) - mean.square(),
                              min=0.0)
            count = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (count / max(count - 1, 1))
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return y.to(self.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in train mode with ``rate > 0`` each
    sample's branch is zeroed with probability ``rate`` and otherwise
    scaled by ``1 / (1 - rate)``; the identity otherwise. The draws come
    from the ``generator`` passed in (on x's device), never from the global
    random state."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in train mode needs a generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


ACTIVATIONS = ("relu", "leakyrelu", "prelu", "gelu", "hswish")


class Activation(nn.Module):
    """relu, leakyrelu (slope ``neg_slope``), prelu (a learned slope,
    initially ``neg_slope``, cast to the input's dtype), gelu with the
    exact erf, or hswish ``x * clip(x + 3, 0, 6) / 6``."""

    def __init__(self, act: str = "relu", neg_slope: float = 0.2):
        super().__init__()
        self.act = act.lower()
        self.neg_slope = neg_slope
        if self.act not in ACTIVATIONS:
            raise NotImplementedError(f"activation [{act}] is not found")
        if self.act == "prelu":
            self.weight = nn.Parameter(torch.full((1,), float(neg_slope)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "gelu":
            return F.gelu(x)
        if self.act == "relu":
            return F.relu(x)
        if self.act == "leakyrelu":
            return F.leaky_relu(x, self.neg_slope)
        if self.act == "prelu":
            return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)
        return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class PointwiseConv(nn.Module):
    """1x1 convolution over the channel (last) axis as a (grouped) matmul.
    ``weight`` has the torch layout ``(Cout, Cin/groups, 1, 1)``."""

    def __init__(self, in_features: int, out_features: int, groups: int = 1,
                 use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if in_features % groups or out_features % groups:
            raise ValueError(f"channels ({in_features}->{out_features}) not "
                             f"divisible by groups={groups}")
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features // groups, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, 0, 0].to(self.dtype)     # (Cout, Cin/g)
        x = x.to(self.dtype)
        g = self.groups
        if g == 1:
            y = x @ w.t()
        else:
            lead, cin = x.shape[:-1], x.shape[-1]
            xg = x.reshape(-1, g, cin // g).transpose(0, 1)   # (g, rows, i)
            wg = w.reshape(g, -1, cin // g)                   # (g, o, i)
            y = torch.bmm(xg, wg.transpose(1, 2)).transpose(0, 1)
            y = y.reshape(*lead, w.shape[0])
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class BasicConv(nn.Sequential):
    """[1x1 grouped conv -> BN -> act] stack; mmcls indices conv 0, norm 1,
    act 2 for each stage of the stack."""

    def __init__(self, channels: Sequence[int], act: str | None = "relu",
                 norm: str | None = None, use_bias: bool = True,
                 groups: int = 4, dtype: torch.dtype = torch.float32):
        layers: list[nn.Module] = []
        for cin, cout in zip(channels[:-1], channels[1:]):
            layers.append(PointwiseConv(cin, cout, groups, use_bias, dtype))
            if norm is not None and norm.lower() != "none":
                layers.append(BatchNorm(cout, dtype=dtype))
            if act is not None and act.lower() != "none":
                layers.append(Activation(act))
        super().__init__(*layers)


class ConvNorm(nn.Sequential):
    """Ungrouped 1x1 conv + BN (the Grapher/FFN fc blocks)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(PointwiseConv(in_features, out_features, dtype=dtype),
                         BatchNorm(out_features, dtype=dtype))


class FFN(nn.Module):
    """fc1 -> act -> fc2 with a DropPath residual."""

    def __init__(self, in_features: int, hidden_features: int,
                 act: str = "relu", drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = ConvNorm(in_features, hidden_features, dtype)
        self.act = Activation(act)
        self.fc2 = ConvNorm(hidden_features, in_features, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.drop_path(self.fc2(self.act(self.fc1(x))), generator) + x


class Conv3x3(nn.Module):
    """3x3 convolution, padding 1, on NHWC tensors; ``weight`` has the torch
    layout ``(Cout, Cin, 3, 3)``."""

    def __init__(self, in_features: int, out_features: int, stride: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an NHWC tensor seen as NCHW is channels-last in memory: the
        # convolution takes and returns that layout without copies
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), self.bias.to(self.dtype),
                     stride=self.stride, padding=1)
        return y.permute(0, 2, 3, 1)


class Stem(nn.Module):
    """Image -> stride-4 patch grid: 3 convs with BN (+act) between. The
    mmcls sequence is convs.[conv, bn, act, conv, bn, act, conv, bn]."""

    def __init__(self, in_features: int, out_dim: int, act: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convs = nn.Sequential(
            Conv3x3(in_features, out_dim // 2, 2, dtype),
            BatchNorm(out_dim // 2, dtype=dtype), Activation(act),
            Conv3x3(out_dim // 2, out_dim, 2, dtype),
            BatchNorm(out_dim, dtype=dtype), Activation(act),
            Conv3x3(out_dim, out_dim, 1, dtype),
            BatchNorm(out_dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class Downsample(nn.Module):
    """3x3 stride-2 conv + BN between stages (mmcls ``conv.[conv, bn]``)."""

    def __init__(self, in_features: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Sequential(Conv3x3(in_features, out_dim, 2, dtype),
                                  BatchNorm(out_dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def avg_pool_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """Non-overlapping r x r average pooling of an NHWC tensor."""
    b, h, w, c = x.shape
    return x.reshape(b, h // r, r, w // r, r, c).mean(dim=(2, 4))
