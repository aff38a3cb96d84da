"""FLOPs and parameters (counterpart: ``tools/analysis_tools/get_flops.py``).

The analytic count (``utils.profiling.model_flops``, closed form, per
component) and the parameter count need no card. ``--verify`` counts the
FLOPs that one forward at batch 1 executes, with
``torch.utils.flop_counter.FlopCounterMode`` (the port's stand-in for XLA's
cost analysis; the kernels' operators count their distance products, see
``utils/profiling.py``), on the card unless ``--device cpu`` is given.

    python -m gkgnet_tpu_torch.tools.analysis_tools.get_flops [CONFIG] \\
        [--shape 576 576] [--arch s] [--verify] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from gkgnet_tpu_torch.core.builder import build_model
from gkgnet_tpu_torch.entry import resolve_device
from gkgnet_tpu_torch.nn.classifier import GKGNetClassifier, init_parameters
from gkgnet_tpu_torch.nn.gkgnet import ARCH_SETTINGS
from gkgnet_tpu_torch.tools.train import load_config
from gkgnet_tpu_torch.utils.profiling import model_flops

SMALL = 224  # the parameter count's build size (k = 9 needs >= 224)


def count_params(arch: str, size: int, n_classes: int = 80,
                 num_gcn: int = 1) -> int:
    """Parameters of the classifier at ``size``, without allocating them:
    built on the meta device at SMALL (only ``pos_embed`` depends on the
    size; k and the groups on nothing), its term corrected to ``size``."""
    with torch.device("meta"):
        model = GKGNetClassifier(arch=arch, size=SMALL, n_classes=n_classes,
                                 num_gcn=num_gcn)
    n = sum(p.numel() for p in model.parameters())
    c0 = ARCH_SETTINGS[arch]["channels"][0]
    return n + ((size // 4) ** 2 - (SMALL // 4) ** 2) * c0


def count_executed(model_cfg: dict, device: torch.device) -> int:
    """FLOPs that one eval forward at batch 1 executes (FlopCounterMode),
    the config's model with its seeded init on ``device``."""
    model = build_model(model_cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    # no tensor requires a gradient: FlopCounterMode's module tracker fails
    # on a view of a parameter taken under no_grad (the label embeddings)
    model = model.to(device).eval().requires_grad_(False)
    size = model_cfg["size"]
    x = torch.randn((1, size, size, 3),
                    generator=torch.Generator().manual_seed(0)).to(device)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x)
    return counter.get_total_flops()


def main(argv=None) -> dict:
    """Returns ``{'params', 'flops' (the analytic dict), 'executed' (with
    --verify)}``."""
    p = argparse.ArgumentParser(description="FLOPs and parameters")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--shape", type=int, nargs="+", default=[576, 576])
    p.add_argument("--arch", default="s")
    p.add_argument("--verify", action="store_true",
                   help="count the FLOPs one forward executes "
                        "(FlopCounterMode)")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model_cfg = dict(arch=args.arch, size=args.shape[0])
    if args.config:
        model_cfg = dict(load_config(args.config, args.cfg_options).model)
    arch, size = model_cfg.get("arch", "s"), model_cfg["size"]
    n_classes = model_cfg.get("n_classes", 80)
    num_gcn = model_cfg.get("num_gcn", 1)

    fl = model_flops(arch, size, 1, n_classes=n_classes, num_gcn=num_gcn)
    n_params = count_params(arch, size, n_classes, num_gcn)
    print("=" * 30)
    print(f"Input shape: (1, {size}, {size}, 3)   arch={arch}")
    print(f"Params: {n_params / 1e6:.2f} M")
    print(f"FLOPs (analytic): {fl['per_image_total'] / 1e9:.2f} G")
    for key, v in fl.items():
        if key not in ("total", "per_image_total"):
            print(f"  {key:>14}: {v / 1e9:8.2f} G")
    out = dict(params=n_params, flops=fl)
    if args.verify:
        device = resolve_device(args.device)
        executed = count_executed(model_cfg, device)
        print(f"FLOPs (executed, FlopCounterMode on {device.type}): "
              f"{executed / 1e9:.2f} G (ratio "
              f"{executed / fl['per_image_total']:.3f})")
        out["executed"] = executed
    print("=" * 30)
    return out


if __name__ == "__main__":
    main()
