"""Import a reference GKGNet checkpoint into the port (counterpart:
``tools/convert_models/torch2jax.py`` with
``gkgnet_tpu/utils/torch_convert.py``'s ``convert_reference_checkpoint``).

    python -m gkgnet_tpu_torch.tools.convert_models.from_reference \\
        gkgnet_coco_576.pth.tar configs/gkgnet_coco_576.py OUT_DIR \\
        [--partial] [--prefix backbone.]

A ``.pth`` / ``.pth.tar`` goes in: a bare state_dict, or the reference's
container ``{'state_dict': ..., 'meta': ...}`` with DDP's ``module.``
prefix. ``OUT_DIR/0/`` comes out: a port checkpoint holding the weights
(no optimizer state) that ``tools.test``, ``tools.inference``,
``--load-from`` and ``core.checkpoint.load_params_only`` read.

The port's ``state_dict`` carries the reference's mmcls key names and
layouts, so the import is by key: the prefix is stripped (and ``--prefix``
prepended), each key of the config's model is looked up, and the
reference's buffers that the port recomputes or does not keep
(``relative_pos``, ``label_input``, ``num_batches_tracked``) are left
unused. Strict by default: a missing key or a shape mismatch raises, with
the JAX converter's message. ``--partial`` (the reference's non-strict
load, for the ImageNet pvig_s backbone bootstrap) keeps the seeded init
where a key is missing or mis-shaped and prints the loaded / missing /
mismatched / unused report. The file is read with
``torch.load(weights_only=True)``: tensors and plain containers only.
"""

from __future__ import annotations

import argparse

import torch

from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.core.checkpoint import save_checkpoint
from gkgnet_tpu_torch.core.trainer import create_train_state
from gkgnet_tpu_torch.nn.classifier import init_parameters
from gkgnet_tpu_torch.tools.train import load_config

# reference buffers with no counterpart in the port's state_dict
RECOMPUTED = ("num_batches_tracked", "relative_pos", "label_input")


class ConversionError(KeyError):
    pass


def load_reference_checkpoint(path: str, prefix: str = ""
                              ) -> dict[str, torch.Tensor]:
    """The state_dict of a reference checkpoint file, DDP's ``module.``
    stripped and ``prefix`` prepended to every key."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {prefix + k.removeprefix("module."): v for k, v in ckpt.items()}


def convert_reference_state_dict(state_dict: dict, target: dict,
                                 strict: bool = True,
                                 report: dict | None = None
                                 ) -> dict[str, torch.Tensor]:
    """``target`` (a model's state_dict) filled from the reference's
    ``state_dict``, each tensor in the target's dtype.

    strict: a key of ``target`` absent from ``state_dict`` or of another
    shape raises ``ConversionError`` naming them. Otherwise those keys keep
    the target's tensor, and ``report`` gets sorted ``loaded``, ``missing``,
    ``mismatched`` ((key, reference shape, port shape)) and ``unused``
    (reference keys not consumed, but for RECOMPUTED buffers) lists."""
    out, loaded, missing, mismatched = {}, [], [], []
    for key, want in target.items():
        got = state_dict.get(key)
        if got is None:
            missing.append(key)
        elif tuple(got.shape) != tuple(want.shape):
            mismatched.append((key, tuple(got.shape), tuple(want.shape)))
        else:
            loaded.append(key)
            out[key] = got.detach().to(want.dtype).clone()
            continue
        out[key] = want
    if strict and (missing or mismatched):
        raise ConversionError(
            f"missing keys: {missing[:10]}"
            f"{'...' if len(missing) > 10 else ''}; "
            f"shape mismatches: {mismatched[:10]}")
    if report is not None:
        report.update(
            loaded=sorted(loaded), missing=sorted(missing),
            mismatched=sorted(mismatched, key=str),
            unused=sorted(k for k in state_dict
                          if k not in target and not k.endswith(RECOMPUTED)))
    return out


def main(argv=None) -> dict:
    """Returns ``{'out', 'report'}`` (the report with --partial)."""
    p = argparse.ArgumentParser(
        description="Reference GKGNet .pth -> a port checkpoint")
    p.add_argument("torch_checkpoint")
    p.add_argument("config")
    p.add_argument("out_dir")
    p.add_argument("--partial", action="store_true",
                   help="non-strict import: keys absent from the checkpoint "
                        "keep their seeded init; prints a loaded/missing/"
                        "unused report (the pvig_s backbone bootstrap)")
    p.add_argument("--prefix", default="",
                   help="prepend to every checkpoint key (pvig_s "
                        "backbone-only checkpoints need --prefix backbone.)")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.cfg_options)
    model = build_model(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(0))
    sd = load_reference_checkpoint(args.torch_checkpoint, args.prefix)
    report: dict = {}
    converted = convert_reference_state_dict(
        sd, model.state_dict(), strict=not args.partial,
        report=report if args.partial else None)
    if args.partial:
        print(f"partial import: {len(report['loaded'])} loaded, "
              f"{len(report['missing'])} kept at init, "
              f"{len(report['mismatched'])} shape-mismatched, "
              f"{len(report['unused'])} checkpoint keys unused")
        for kind in ("mismatched", "unused"):
            for item in report[kind][:20]:
                print(f"  {kind}: {item}")
    model.load_state_dict(converted, strict=True)
    out = save_checkpoint(
        args.out_dir, create_train_state(model, optimizer=None), epoch=0,
        meta={"source": args.torch_checkpoint, "partial": args.partial})
    print(f"converted -> {out}")
    return dict(out=out, report=report)


if __name__ == "__main__":
    main()
