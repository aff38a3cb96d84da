"""The learning-rate schedule of a config, simulated and plotted
(counterpart: ``tools/visualizations/vis_lr.py``; needs matplotlib).

    python -m gkgnet_tpu_torch.tools.visualizations.vis_lr CONFIG \\
        [--steps-per-epoch 1000] [--out lr_schedule.png]
"""

from __future__ import annotations

import argparse

import numpy as np

from gkgnet_tpu_torch.core.config import Config
from gkgnet_tpu_torch.core.schedules import build_lr_schedule


def schedule(cfg: Config, steps_per_epoch: int
             ) -> tuple[np.ndarray, list[float]]:
    """The steps sampled (about 2000 over the run) and the lr at each."""
    lr_cfg = dict(cfg.lr_config)
    lr_cfg["base_lr"] = cfg.optimizer["lr"]
    sched = build_lr_schedule(lr_cfg, steps_per_epoch)
    total = cfg["runner"]["max_epochs"] * steps_per_epoch
    xs = np.arange(0, total, max(total // 2000, 1))
    return xs, [float(sched(x)) for x in xs]


def main(argv=None) -> tuple[np.ndarray, list[float]]:
    """Returns the steps sampled and their lr."""
    p = argparse.ArgumentParser(description="Plot the lr schedule")
    p.add_argument("config")
    p.add_argument("--steps-per-epoch", type=int, default=1000)
    p.add_argument("--out", default="lr_schedule.png")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, ys = schedule(Config.fromfile(args.config), args.steps_per_epoch)
    plt.plot(xs / args.steps_per_epoch, ys)
    plt.xlabel("epoch")
    plt.ylabel("lr")
    plt.yscale("log")
    plt.savefig(args.out, dpi=150)
    print(f"saved {args.out}")
    return xs, ys


if __name__ == "__main__":
    main()
