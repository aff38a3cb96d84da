"""(Counterpart: ``gkgnet_tpu/core/config.py``, a copy but for one rule.)
Python-file config system with ``_base_`` inheritance and dotted-key CLI
overrides — the semantics of mmcv.Config (reference configs use
``_base_ = [...]`` multi-inheritance + ``--cfg-options`` deep merge,
tools/train.py:58-67) without mmcv.

A config file is plain Python; its module-level names become the config
dict. ``_base_`` (str or list) is loaded first and deep-merged under the
child (child wins; a dict value containing ``_delete_: True`` replaces the
base dict wholesale).

The rule the JAX package lacks: a child dict that names a ``type`` other
than a base dataset wrapper's (``DATASET_WRAPPERS``) replaces the wrapper
wholesale too, as the wrapper's own keys (``dataset``, ``datasets``,
``times``, ``oversample_thr``) are no arguments of the set that takes its
place. ``configs/gkgnet_voc_448.py`` needs it: its ``data.train`` (a VOC
set) lies over the COCO base's ClassBalancedDataset, and a merge keeps that
wrapper's ``oversample_thr`` and ``dataset``, which the VOC dataset does not
take (the JAX package's ``build_dataset`` raises there). Any other type
switch (an optimizer, a model part) merges as in mmcv and the JAX package:
the base's other keys stay.
"""

from __future__ import annotations

import copy
import os
import types
from typing import Any

DELETE_KEY = "_delete_"
DATASET_WRAPPERS = ("ClassBalancedDataset", "RepeatDataset", "ConcatDataset")


def _replaces_wrapper(base: dict, child: dict) -> bool:
    """True when ``base`` is a dataset wrapper and ``child`` names another
    type."""
    return base.get("type") in DATASET_WRAPPERS and "type" in child \
        and child["type"] != base["type"]


def _deep_merge(base: dict, child: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in child.items():
        if isinstance(v, dict) and v.get(DELETE_KEY):
            v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            out[k] = copy.deepcopy(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict) \
                and not _replaces_wrapper(out[k], v):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _exec_config_file(path: str) -> dict:
    with open(path) as f:
        code = f.read()
    module = types.ModuleType("config")
    module.__file__ = path
    exec(compile(code, path, "exec"), module.__dict__)
    return {
        k: v for k, v in module.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v) or k == "_base_"
    }


class Config(dict):
    """dict with attribute access (cfg.model.backbone.k style)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Config.wrap(v)

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    @staticmethod
    def wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        return v

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        cfg = _exec_config_file(path)
        bases = cfg.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: dict = {}
        for b in bases:
            base_cfg = cls.fromfile(os.path.join(os.path.dirname(path), b))
            merged = _deep_merge(merged, base_cfg)
        merged = _deep_merge(merged, cfg)
        return cls(merged)

    def merge_from_options(self, options: dict[str, Any]):
        """Apply ``{"a.b.c": value}`` overrides (mmcv DictAction)."""
        for key, value in options.items():
            parts = key.split(".")
            d = self
            for p in parts[:-1]:
                if p not in d or not isinstance(d[p], dict):
                    d[p] = {}
                d = d[p]
            d[parts[-1]] = value

    def dump(self, path: str):
        import json

        with open(path, "w") as f:
            json.dump(self, f, indent=2, default=repr)

    def pretty_text(self) -> str:
        import json

        return json.dumps(self, indent=2, default=repr)


def parse_cfg_option(value: str) -> Any:
    """Parse a CLI override value: int/float/bool/None/list literals."""
    import ast

    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
