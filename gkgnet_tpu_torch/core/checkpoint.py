"""Checkpoint save, resume and weights-only load on ``torch.save``
(counterpart: ``gkgnet_tpu/core/checkpoint.py``, orbax).

Layout: one ``<directory>/<epoch>/`` per save, holding ``state.pt`` and
``meta.json`` (epoch, CLASSES, best metric). ``state.pt`` holds all that an
exact resume needs:

  * ``model``: the model's ``state_dict`` (parameters and BatchNorm
    buffers, the reference's mmcls key names);
  * ``optimizer``: the torch optimizer's ``state_dict`` (AdamW's moments and
    their per-parameter step counts);
  * ``step``: ``TrainState.step``, which seeds each step's random draws;
  * ``ema_params``, ``loss_scale``, ``good_steps``.

A save of a state without an optimizer (``optimizer`` None: the weights
alone, as ``tools.convert_models.from_reference`` writes) is read by
``load_params_only``; ``restore_checkpoint`` refuses it.

Tensors are saved on the CPU and restored onto the model's device. The JAX
package's orbax directories are not read: JAX weights reach the port only
through ``gkgnet_tpu_torch.utils.weights``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import torch

from gkgnet_tpu_torch.core.trainer import TrainState

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def epochs(directory: str) -> list[int]:
    """The saved epochs under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if re.fullmatch(r"\d+", d))


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    meta: dict | None = None,
                    max_to_keep: int | None = 3) -> str:
    """Write ``<directory>/<epoch>/`` (replacing a save of the same epoch)
    and keep the newest ``max_to_keep`` epochs. Returns the epoch's
    directory."""
    out = os.path.join(directory, str(epoch))
    tmp = f"{out}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({
        "model": _cpu(state.model.state_dict()),
        "optimizer": (None if state.optimizer is None
                      else _cpu(state.optimizer.optimizer.state_dict())),
        "step": state.step,
        "ema_params": _cpu(state.ema_params),
        "loss_scale": state.loss_scale,
        "good_steps": state.good_steps,
    }, os.path.join(tmp, STATE_FILE))
    with open(os.path.join(tmp, META_FILE), "w") as f:
        json.dump(dict(meta or {}, epoch=epoch), f)
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    if max_to_keep:
        for old in epochs(directory)[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)))
    return out


def latest_epoch(directory: str) -> int | None:
    found = epochs(directory)
    return found[-1] if found else None


def _load(directory: str, epoch: int | None) -> tuple[dict, int, dict]:
    if epoch is None:
        epoch = latest_epoch(directory)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, str(epoch), STATE_FILE)
    if not os.path.isfile(path):
        raise ValueError(
            f"{os.path.join(directory, str(epoch))} holds no {STATE_FILE}: "
            f"not a checkpoint of this package (the JAX package's orbax "
            f"checkpoints are not read; carry JAX weights across with "
            f"gkgnet_tpu_torch.utils.weights.load_jax_variables)")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    meta: dict[str, Any] = {}
    meta_path = os.path.join(directory, str(epoch), META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return raw, epoch, meta


def restore_checkpoint(directory: str, state: TrainState,
                       epoch: int | None = None
                       ) -> tuple[TrainState, int, dict]:
    """Restore a save (the newest, unless ``epoch`` is given) into
    ``state`` in place: the model, the optimizer, the step, the EMA and the
    loss scaler. Returns ``(state, epoch, meta)``."""
    raw, epoch, meta = _load(directory, epoch)
    if raw["optimizer"] is None:
        raise ValueError(f"{directory}/{epoch} holds weights only (no "
                         f"optimizer state): load it with load_params_only "
                         f"(--load-from), not as a resume")
    state.model.load_state_dict(raw["model"], strict=True)
    state.optimizer.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    if (raw["ema_params"] is None) != (state.ema_params is None):
        raise ValueError(f"{directory}/{epoch}: the saved EMA and the run's "
                         f"EMA setting disagree")
    if state.ema_params is not None:
        with torch.no_grad():
            for name, t in state.ema_params.items():
                t.copy_(raw["ema_params"][name])
    state.loss_scale, state.good_steps = raw["loss_scale"], raw["good_steps"]
    return state, epoch, meta


def load_params_only(directory: str, model: torch.nn.Module,
                     epoch: int | None = None, ema: bool = False
                     ) -> tuple[int, dict]:
    """Weights-only load (the reference's ``load_from``, and the test
    CLI's): the model's parameters and buffers, with the saved EMA
    parameters in place of the raw ones when ``ema`` is set. Returns
    ``(epoch, meta)``."""
    raw, epoch, meta = _load(directory, epoch)
    sd = dict(raw["model"])
    if ema:
        if raw["ema_params"] is None:
            raise ValueError(f"{directory}/{epoch} holds no EMA parameters")
        sd.update(raw["ema_params"])
    model.load_state_dict(sd, strict=True)
    return epoch, meta
