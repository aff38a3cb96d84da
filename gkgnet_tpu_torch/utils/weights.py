"""Load the JAX package's variable tree into the port.

``load_jax_variables(model, variables)`` takes the tree that
``gkgnet_tpu``'s ``GKGNetClassifier.init`` returns (``params`` and
``batch_stats`` as nested dicts of numpy arrays; ``constants`` is ignored,
since the port recomputes its relative-position tables) and fills the
port's parameters and buffers. The port's ``state_dict`` uses the
reference's mmcls key names, so the mapping here is the inverse of the JAX
package's torch-checkpoint converter, with its own copy of the layout
transforms:

  * 3x3 conv     (kh, kw, Cin, Cout)    -> (Cout, Cin, kh, kw)
  * 1x1 conv     (G, Cin/G, Cout/G)     -> (Cout, Cin/G, 1, 1)
  * Dense        (Cin, Cout)            -> Linear (Cout, Cin)
  * pos_embed    (1, H, W, C)           -> (1, C, H, W)
  * BatchNorm    scale/bias, mean/var   -> weight/bias, running_mean/var
  * head fc1_kernel (C_cls, Cin)        -> head.fc1.weight as it is
  * aggregator leaves: ``gconv/{nn,nn1,nn2}`` (BasicConv) ->
    ``graph_conv.gconv.{nn,nn1,nn2}.<i>``, the gat attention ``gconv/a``
    (a 1x1 conv) -> ``graph_conv.gconv.a``, the gin ``gconv/eps`` (1,) ->
    ``graph_conv.gconv.eps`` as it is
  * a prelu's ``act*/alpha`` (1,) -> the activation's ``weight`` (torch
    ``nn.PReLU``'s name): ``stem.convs.{2,5}``, ``ffn.act``,
    ``gconv.nn.<3i+2>``
  * the linear heads' ``head/fc`` -> ``head.fc`` (a Dense)
  * the neck's leaves -> ``neck.*`` under the JAX module names: its convs
    (``neck.proj0``, ``neck.fuse``, ...) as 3x3 / 1x1 convs, the
    projection's ``neck/kernel`` (C_cls, Cin, P) and ``neck/bias`` as they
    are

``init_block_parameters(module, generator)`` is the seeded init of any
module of the port (a standalone Grapher as well as the classifier).
"""

from __future__ import annotations

import re
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from gkgnet_tpu_torch.nn.layers import (Activation, BatchNorm, Conv3x3,
                                        PointwiseConv)

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "embedding": "weight", "mean": "running_mean", "var": "running_var",
         "eps": "eps", "alpha": "weight"}
_STEM = {"conv0": 0, "norm0": 1, "act0": 2, "conv1": 3, "norm1": 4,
         "act1": 5, "conv2": 6, "norm2": 7}
_CONV_NORM = {"conv": "0", "norm": "1"}


def _walk(tree: dict, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _block_path(p: list[str]) -> list[str]:
    """Path inside a Grapher, GrapherLabel or FFN -> mmcls sub-keys."""
    if p[0] in ("fc1", "fc2"):                    # ConvNorm
        return [p[0], _CONV_NORM[p[1]]]
    if p[0] == "act":                             # an FFN's prelu
        return ["act"]
    if p[0] == "graph_conv":
        if len(p) == 2 or p[2] == "a":            # gin eps, gat attention
            return p[:3]
        # gconv.nn*: a BasicConv, conv / norm / act of each stage
        m = re.fullmatch(r"(conv|norm|act)(\d+)", p[3])
        idx = 3 * int(m.group(2)) + {"conv": 0, "norm": 1, "act": 2}[m.group(1)]
        return ["graph_conv", "gconv", p[2], str(idx)]
    if p[0] == "ffn":                             # FFN inside GrapherLabel
        return ["ffn"] + _block_path(p[1:])
    raise KeyError(f"unmapped module path {p}")


def torch_key(path: tuple[str, ...]) -> str:
    """JAX variable path (without the collection) -> mmcls state_dict key."""
    *mods, leaf = path
    if mods[0] == "neck":
        return ".".join(["neck", *mods[1:], leaf if len(mods) == 1
                         else _LEAF[leaf]])
    if mods[0] == "head":
        if leaf.startswith("fc1_"):
            return f"head.fc1.{_LEAF[leaf[4:]]}"
        return f"head.{mods[1]}.{_LEAF[leaf]}"
    mods = mods[1:]                               # drop 'backbone'
    if not mods:
        if leaf != "pos_embed":
            raise KeyError(f"unmapped backbone leaf {leaf}")
        return "backbone.pos_embed"
    name = mods[0]
    if name == "stem":
        parts = ["stem", "convs", str(_STEM[mods[1]])]
    elif name == "label_lt":
        parts = ["label_lt"]
    elif m := re.fullmatch(r"backbone_(\d+)(?:_(grapher|ffn))?", name):
        parts = ["backbone", m.group(1)]
        if m.group(2) is None:                    # Downsample
            parts += ["conv", _CONV_NORM[mods[1]]]
        else:
            parts += ["0" if m.group(2) == "grapher" else "1"]
            parts += _block_path(mods[1:])
    elif m := re.fullmatch(r"gcn_label_(\d+)_(\d+)", name):
        parts = ["gcn_label", m.group(1), m.group(2)] + _block_path(mods[1:])
    elif m := re.fullmatch(r"ffn_label_(\d+)", name):
        parts = ["ffn_label", m.group(1), "0"]
    else:
        raise KeyError(f"unmapped path {path}")
    return ".".join(["backbone", *parts, _LEAF[leaf]])


def jax_leaf_names(model: nn.Module) -> dict[str, str]:
    """Parameter name -> the leaf name of the JAX variable it is loaded from
    (the inverse of the last step of ``torch_key``): ``kernel``, ``bias``,
    ``scale``, ``embedding``, ``pos_embed``, ``eps``, ``alpha`` (a prelu's
    slope), ``fc1_kernel`` or ``fc1_bias``."""
    names = {}
    for mod_name, module in model.named_modules():
        for p_name, _ in module.named_parameters(recurse=False):
            key = f"{mod_name}.{p_name}" if mod_name else p_name
            if key in ("head.fc1.weight", "head.fc1.bias"):
                leaf = "fc1_kernel" if p_name == "weight" else "fc1_bias"
            elif p_name in ("pos_embed", "eps", "kernel"):
                leaf = p_name
            elif isinstance(module, Activation):
                leaf = "alpha"
            elif isinstance(module, BatchNorm):
                leaf = {"weight": "scale", "bias": "bias"}[p_name]
            elif isinstance(module, nn.Embedding):
                leaf = "embedding"
            else:
                leaf = {"weight": "kernel", "bias": "bias"}[p_name]
            names[key] = leaf
    return names


def to_torch_layout(path: tuple[str, ...], value) -> np.ndarray:
    """One JAX leaf -> the torch layout of its state_dict entry."""
    a = np.asarray(value, dtype=np.float32)
    leaf = path[-1]
    if path[0] == "neck" and len(path) == 2:      # the projection's leaves
        return a
    if leaf == "pos_embed":
        return a.transpose(0, 3, 1, 2)
    if leaf != "kernel":
        return a
    if a.ndim == 4:                               # 3x3 conv
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 3:                               # 1x1 conv, G groups
        g, cin_g, cout_g = a.shape
        return a.transpose(0, 2, 1).reshape(g * cout_g, cin_g, 1, 1)
    return a.T                                    # Dense


def state_dict_from_jax(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX tree's ``params`` and ``batch_stats`` as an mmcls-keyed
    state_dict of fp32 tensors."""
    out: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            arr = np.ascontiguousarray(to_torch_layout(path, value))
            out[torch_key(path)] = torch.from_numpy(arr)
    return out


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model``'s parameters and buffers from the JAX tree. Every key
    must match in name and shape (``load_state_dict(strict=True)``)."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)


@torch.no_grad()
def init_block_parameters(module: nn.Module,
                          generator: torch.Generator) -> None:
    """Seeded init of the convolutions of ``module`` and its children, in
    module order: kaiming-normal (fan_in) weights. Biases stay zero, BN
    scales and running variances one, the gin ``eps`` zero, as created."""
    for sub in module.modules():
        if isinstance(sub, (PointwiseConv, Conv3x3)):
            fan_in = sub.weight[0].numel()
            sub.weight.normal_(0.0, (2.0 / fan_in) ** 0.5,
                               generator=generator)
