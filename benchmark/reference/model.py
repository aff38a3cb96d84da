"""Plain GKGNet in PyTorch: the forward pass as the published GKGNet and
Pyramid ViG describe it, written out with plain ``torch`` operations on a
dict of named tensors. No kernel, cache or batching trick, and nothing of
the program under test: the parameter names follow the reference's mmcls
``state_dict``, so one dict of weights made by the benchmark feeds both.

The model (``cfg`` is a configuration's model dict: ``arch``, ``size``,
``k``, ``k_label_gcn``, ``num_group``, ``n_classes``, ``num_gcn``,
``drop_path``):

  * stem: three 3x3 convs (stride 2, 2, 1) with BN, GELU between them; a
    learned position embedding is added;
  * four stages of Grapher + FFN blocks (a 3x3 stride-2 conv + BN between
    stages). A Grapher is fc1 (1x1 conv + BN), the graph conv, fc2 (1x1
    conv + BN) and a DropPath residual; an FFN is 1x1 conv + BN, GELU, 1x1
    conv + BN and a DropPath residual;
  * the graph conv folds ``num_group`` channel groups into the batch; each
    group's nodes are L2-normalized, the squared distances to the targets
    (the r x r average-pooled map, r = 4, 2, 1, 1) get the negated
    relative-position table added, the ``k * dilation`` nearest are taken
    and every ``dilation``-th kept (dilation ``min(i // 4 + 1, 49 // k)``
    for the i-th block); the max-relative aggregate ``max_j(y_j - x)`` is
    interleaved channel by channel with x and mixed by a 1x1 conv of 4
    groups, BN and GELU;
  * at the end of each stage the 80 label tokens (a learned embedding)
    query the stage's map through the same graph conv (k_label_gcn, no
    bias, no pooling) in a Grapher + FFN of their own, and are projected to
    the next stage's width;
  * the head's score of class c is ``<label_c, w1_c> + b1_c`` plus a
    linear layer of the map's global average.

DropPath rates grow as ``linspace(0, drop_path, blocks)``; a stage's label
block takes the rate of the stage's first block. In training each
DropPath draws one uniform number per sample from the step's generator, in
the order the forward reaches them.

``cast`` stands for the compute type: it is applied wherever a value is
rounded to it (the operands and results of convolutions and products,
normalization results, activations, residual sums). The identity gives
the fp32 reference; ``round_to("fp8")`` gives the fp8 control.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

ARCHS = {
    "t": ((2, 2, 6, 2), (48, 96, 240, 384)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "b": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}
REDUCE_RATIOS = (4, 2, 1, 1)
BN_EPS = 1e-5
# rows of a distance block: query rows per block x targets x batch rows
DIST_BLOCK = 1 << 27


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def round_to(kind: str):
    """``cast`` for a lower compute type: ``bf16`` rounds to bfloat16;
    ``fp8`` to float8 e4m3 with a per-tensor scale (the largest magnitude
    maps to 448), as fp8 compute scales its operands."""
    if kind == "bf16":
        return lambda t: t.to(torch.bfloat16).to(t.dtype)
    if kind != "fp8":
        raise ValueError(f"unknown compute type {kind}")
    return _Fp8.apply


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float()
            / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Rounds the value to fp8 and its gradient to fp8 too."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


# ----------------------------------------------------------- parameters


def _conv(out: list, name: str, cout: int, cin: int, kh: int) -> None:
    out.append((f"{name}.weight", (cout, cin, kh, kh), "conv"))
    out.append((f"{name}.bias", (cout,), "bias"))


def _bn(out: list, name: str, c: int) -> None:
    out.append((f"{name}.weight", (c,), "bn_weight"))
    out.append((f"{name}.bias", (c,), "bn_bias"))


def _convnorm(out: list, name: str, cout: int, cin: int, groups: int = 1):
    _conv(out, f"{name}.0", cout, cin // groups, 1)
    _bn(out, f"{name}.1", cout)


def _grapher(out: list, name: str, c: int) -> None:
    _convnorm(out, f"{name}.fc1", c, c)
    _convnorm(out, f"{name}.graph_conv.gconv.nn", 2 * c, 2 * c, groups=4)
    _convnorm(out, f"{name}.fc2", c, 2 * c)


def _ffn(out: list, name: str, c: int) -> None:
    _convnorm(out, f"{name}.fc1", 4 * c, c)
    _convnorm(out, f"{name}.fc2", c, 4 * c)


def param_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter, in a fixed order; kind
    is conv, bias, bn_weight, bn_bias, linear, pos_embed, label_embedding
    or head."""
    blocks, ch = ARCHS[cfg["arch"]]
    hw = cfg["size"] // 4
    out: list = [("backbone.pos_embed", (1, ch[0], hw, hw), "pos_embed")]
    _conv(out, "backbone.stem.convs.0", ch[0] // 2, 3, 3)
    _bn(out, "backbone.stem.convs.1", ch[0] // 2)
    _conv(out, "backbone.stem.convs.3", ch[0], ch[0] // 2, 3)
    _bn(out, "backbone.stem.convs.4", ch[0])
    _conv(out, "backbone.stem.convs.6", ch[0], ch[0], 3)
    _bn(out, "backbone.stem.convs.7", ch[0])
    out.append(("backbone.label_lt.weight", (cfg["n_classes"], ch[0]),
                "label_embedding"))
    j = 0
    for i, nb in enumerate(blocks):
        if i > 0:
            _conv(out, f"backbone.backbone.{j}.conv.0", ch[i], ch[i - 1], 3)
            _bn(out, f"backbone.backbone.{j}.conv.1", ch[i])
            j += 1
        for _ in range(nb):
            _grapher(out, f"backbone.backbone.{j}.0", ch[i])
            _ffn(out, f"backbone.backbone.{j}.1", ch[i])
            j += 1
    for i in range(len(blocks)):
        taps = cfg.get("num_gcn", 1) if i == len(blocks) - 1 else 1
        for t in range(taps):
            name = f"backbone.gcn_label.{i}.{t}"
            _grapher(out, name, ch[i])
            _ffn(out, f"{name}.ffn", ch[i])
    for i in range(len(blocks) - 1):
        out.append((f"backbone.ffn_label.{i}.0.weight", (ch[i + 1], ch[i]),
                    "linear"))
        out.append((f"backbone.ffn_label.{i}.0.bias", (ch[i + 1],), "bias"))
    for fc in ("fc1", "fc2"):
        out.append((f"head.{fc}.weight", (cfg["n_classes"], ch[-1]), "head"))
        out.append((f"head.{fc}.bias", (cfg["n_classes"],), "bias"))
    return out


def bn_names(cfg: dict) -> list[tuple[str, int]]:
    """``(module name, channels)`` of every BatchNorm, whose running
    statistics are ``<name>.running_mean`` and ``<name>.running_var``."""
    return [(name[:-len(".weight")], shape[0])
            for name, shape, kind in param_specs(cfg) if kind == "bn_weight"]


def decayed(cfg: dict) -> dict[str, bool]:
    """Whether AdamW's weight decay applies to each parameter: not to BN
    scales and biases, nor to any bias but the head's per-class ``fc1``
    bias (the rule of the recipe's ``paramwise_no_decay``)."""
    return {name: kind not in ("bn_weight", "bn_bias")
            and (kind != "bias" or name == "head.fc1.bias")
            for name, _, kind in param_specs(cfg)}


# ------------------------------------------------- relative positions


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``W (n_out, n_in)``: bicubic resize along one axis (A = -0.75,
    align_corners False, border taps clamped)."""
    a = -0.75
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    fl = np.floor(src)
    t = src - fl
    w = np.zeros((n_out, n_in))
    for tap in range(-1, 3):
        x = np.abs(t - tap)
        k = np.where(x <= 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                     np.where(x < 2.0,
                              a * (((x - 5.0) * x + 8.0) * x - 4.0), 0.0))
        cols = np.clip(fl + tap, 0, n_in - 1).astype(np.int64)
        np.add.at(w, (np.arange(n_out), cols), k)
    return w


@functools.lru_cache(maxsize=16)
def relative_pos_table(dim: int, n: int, r: int) -> np.ndarray:
    """The negated relative-position distance bias ``(n, n // r^2)``: the
    2D sin-cos embedding P of the sqrt(n) x sqrt(n) grid, ``2 P P^T / dim``
    resized bicubically along the targets to the pooled count. Computed
    once a process; the caller must not write into it."""
    grid = math.isqrt(n)
    coords = np.arange(grid, dtype=np.float64)
    gw, gh = np.meshgrid(coords, coords)
    p = np.concatenate([_sincos_1d(dim // 2, gw), _sincos_1d(dim // 2, gh)],
                       axis=1)
    if r == 1:
        rel = 2.0 * (p @ p.T) / p.shape[1]
    else:
        rel = 2.0 * (p @ (_bicubic_matrix(n, n // (r * r)) @ p).T) \
            / p.shape[1]
    return (-rel).astype(np.float32)


# --------------------------------------------------------------- model


class PlainGKGNet:
    """``forward(imgs, train, generator)`` -> logits ``(B, n_classes)``
    fp32 for NHWC images; ``params`` and ``stats`` are dicts of tensors on
    one device (``stats`` holds the running statistics, read in eval).
    Where ``record`` is a dict, a train-mode forward stores each BN's batch
    mean and variance in it under the running statistics' names."""

    def __init__(self, cfg: dict, params: dict, stats: dict | None = None,
                 cast=identity):
        self.cfg, self.p, self.stats, self.c = cfg, params, stats, cast
        self.record: dict | None = None
        blocks, ch = ARCHS[cfg["arch"]]
        device = params["backbone.pos_embed"].device
        n = (cfg["size"] // 4) ** 2
        self.tables = []
        for i in range(len(blocks)):
            self.tables.append(torch.from_numpy(relative_pos_table(
                ch[i], n, REDUCE_RATIOS[i])).to(device))
            n //= 4

    # -- layers
    def linear(self, x, w, b, groups: int = 1):
        c = self.c
        x, w = c(x), c(w)
        if groups == 1:
            y = x @ w.t()
        else:
            lead, cin = x.shape[:-1], x.shape[-1]
            xg = x.reshape(-1, groups, cin // groups).transpose(0, 1)
            wg = w.reshape(groups, -1, cin // groups)
            y = torch.bmm(xg, wg.transpose(1, 2)).transpose(0, 1)
            y = y.reshape(*lead, w.shape[0])
        return c(c(y) + c(b))

    def conv1x1(self, x, name: str, groups: int = 1):
        return self.linear(x, self.p[f"{name}.weight"][:, :, 0, 0],
                           self.p[f"{name}.bias"], groups)

    def conv3x3(self, x, name: str, stride: int):
        c = self.c
        y = F.conv2d(c(x).permute(0, 3, 1, 2), c(self.p[f"{name}.weight"]),
                     c(self.p[f"{name}.bias"]), stride=stride, padding=1)
        return c(y.permute(0, 2, 3, 1))

    def bn(self, x, name: str):
        x32 = x.float()
        if self.train:
            axes = tuple(range(x32.dim() - 1))
            mean = x32.mean(dim=axes)
            var = torch.clamp(x32.square().mean(dim=axes) - mean.square(),
                              min=0.0)
            if self.record is not None:
                self.record[f"{name}.running_mean"] = mean.detach()
                self.record[f"{name}.running_var"] = var.detach()
        else:
            mean = self.stats[f"{name}.running_mean"]
            var = self.stats[f"{name}.running_var"]
        y = (x32 - mean) * torch.rsqrt(var + BN_EPS) \
            * self.p[f"{name}.weight"] + self.p[f"{name}.bias"]
        return self.c(y)

    def convnorm(self, x, name: str, groups: int = 1):
        return self.bn(self.conv1x1(x, f"{name}.0", groups), f"{name}.1")

    def gelu(self, x):
        return self.c(F.gelu(x))

    def drop(self, x, rate: float):
        if rate == 0.0 or not self.train:
            return x
        keep = 1.0 - rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=self.gen, device=x.device) < keep
        return self.c(torch.where(mask, self.c(x / keep), 0.0))

    def add(self, a, b):
        return self.c(a + b)

    # -- the graph conv
    @staticmethod
    def fold(x, g: int):
        b, n, c = x.shape
        return x.reshape(b, n, g, c // g).permute(0, 2, 1, 3).reshape(
            b * g, n, c // g)

    @staticmethod
    def unfold(x, g: int):
        bg, n, d = x.shape
        return x.reshape(bg // g, g, n, d).permute(0, 2, 1, 3).reshape(
            bg // g, n, g * d)

    def l2n(self, x):
        x32 = x.float()
        norm = torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))
        return self.c(x32 / torch.clamp(norm, min=1e-12))

    def neighbours(self, xn, yn, bias, kd: int):
        """The kd nearest targets of each query, nearest first, computed in
        blocks of query rows."""
        xn, yn = xn.detach().float(), yn.detach().float()
        bg, n, _ = xn.shape
        m = yn.shape[1]
        y_sq = torch.sum(yn * yn, dim=-1)[:, None, :]
        rows = max(1, min(n, DIST_BLOCK // max(1, bg * m)))
        out = []
        for i in range(0, n, rows):
            xb = xn[:, i:i + rows]
            dist = torch.sum(xb * xb, dim=-1, keepdim=True) \
                - 2.0 * torch.bmm(xb, yn.transpose(1, 2)) + y_sq
            if bias is not None:
                dist = dist + bias[i:i + rows]
            out.append(torch.topk(dist, kd, dim=-1, largest=False,
                                  sorted=True).indices)
        return torch.cat(out, dim=1)

    def max_relative(self, x, y, bias, k: int, dilation: int):
        """``max_j(y[idx_j] - x)`` over the k neighbours kept."""
        xn = self.l2n(x)
        yn = xn if y is x else self.l2n(y)
        idx = self.neighbours(xn, yn, bias, k * dilation)[..., ::dilation]
        bg, n, kk = idx.shape
        d = y.shape[-1]
        flat = idx.reshape(bg, n * kk, 1).expand(bg, n * kk, d)
        yj = torch.gather(y, 1, flat).reshape(bg, n, kk, d)
        return self.c(torch.amax(yj.float() - x.float()[:, :, None, :],
                                 dim=2))

    def graph_conv(self, x, y, name: str, bias, k: int, dilation: int):
        """x ``(B, N, C)`` queries, y ``(B, M, C)`` targets (y is x for
        the self graph) -> ``(B, N, 2C)``."""
        g = self.cfg["num_group"]
        xf = self.fold(x, g)
        yf = xf if y is x else self.fold(y, g)
        mr = self.max_relative(xf, yf, bias, k, dilation)
        h = torch.stack([x, self.unfold(mr, g)], dim=-1).reshape(
            *x.shape[:-1], 2 * x.shape[-1])
        return self.gelu(self.convnorm(h, f"{name}.graph_conv.gconv.nn",
                                       groups=4))

    # -- blocks
    def grapher(self, x, name: str, stage: int, dilation: int, rate: float):
        b, h, w, ch = x.shape
        hx = self.convnorm(x, f"{name}.fc1")
        nodes = hx.reshape(b, h * w, ch)
        r = REDUCE_RATIOS[stage]
        if r > 1:
            pooled = self.c(hx.reshape(b, h // r, r, w // r, r, ch).mean(
                dim=(2, 4)))
            targets = pooled.reshape(b, -1, ch)
        else:
            targets = nodes
        out = self.graph_conv(nodes, targets, name, self.tables[stage],
                              self.cfg["k"], dilation)
        out = self.convnorm(out.reshape(b, h, w, 2 * ch), f"{name}.fc2")
        return self.add(self.drop(out, rate), x)

    def ffn(self, x, name: str, rate: float):
        h = self.gelu(self.convnorm(x, f"{name}.fc1"))
        return self.add(self.drop(self.convnorm(h, f"{name}.fc2"), rate), x)

    def label_block(self, labels, feats, name: str, rate: float):
        b, h, w, ch = feats.shape
        x = self.convnorm(labels, f"{name}.fc1")
        out = self.graph_conv(x, feats.reshape(b, h * w, ch), name, None,
                              self.cfg["k_label_gcn"], 1)
        x = self.add(self.drop(self.convnorm(out, f"{name}.fc2"), rate),
                     labels)
        return self.ffn(x, f"{name}.ffn", rate)

    def forward(self, imgs: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        self.train, self.gen = train, generator
        cfg, p, c = self.cfg, self.p, self.c
        blocks, _ = ARCHS[cfg["arch"]]
        rates = np.linspace(0, cfg.get("drop_path", 0.0), sum(blocks))
        x = self.gelu(self.bn(self.conv3x3(imgs, "backbone.stem.convs.0", 2),
                              "backbone.stem.convs.1"))
        x = self.gelu(self.bn(self.conv3x3(x, "backbone.stem.convs.3", 2),
                              "backbone.stem.convs.4"))
        x = self.bn(self.conv3x3(x, "backbone.stem.convs.6", 1),
                    "backbone.stem.convs.7")
        x = self.add(x, c(p["backbone.pos_embed"].permute(0, 2, 3, 1)))
        b = x.shape[0]
        labels = c(p["backbone.label_lt.weight"])[None].expand(
            b, cfg["n_classes"], -1)
        j = grapher = 0
        for i, nb in enumerate(blocks):
            if i > 0:
                x = self.bn(self.conv3x3(x, f"backbone.backbone.{j}.conv.0",
                                         2), f"backbone.backbone.{j}.conv.1")
                j += 1
            first = grapher
            for _ in range(nb):
                dil = min(grapher // 4 + 1, 49 // cfg["k"])
                rate = float(rates[grapher])
                x = self.grapher(x, f"backbone.backbone.{j}.0", i, dil, rate)
                x = self.ffn(x, f"backbone.backbone.{j}.1", rate)
                j += 1
                grapher += 1
            taps = cfg.get("num_gcn", 1) if i == len(blocks) - 1 else 1
            for t in range(taps):
                labels = self.label_block(labels, x,
                                          f"backbone.gcn_label.{i}.{t}",
                                          float(rates[first]))
            if i < len(blocks) - 1:
                labels = self.linear(labels,
                                     p[f"backbone.ffn_label.{i}.0.weight"],
                                     p[f"backbone.ffn_label.{i}.0.bias"])
        gap = c(x.float().mean(dim=(1, 2))).float()
        score = torch.einsum("bnc,nc->bn", labels.float(),
                             p["head.fc1.weight"]) + p["head.fc1.bias"]
        return score + gap @ p["head.fc2.weight"].t() + p["head.fc2.bias"]
