"""Training-log analysis (counterpart:
``tools/analysis_tools/analyze_logs.py``): the average iteration window of
each epoch of a ``.log.json``, or metric curves plotted to a PNG (needs
matplotlib). No model, no card.

    python -m gkgnet_tpu_torch.tools.analysis_tools.analyze_logs \\
        cal_train_time RUN.log.json [..]
    python -m gkgnet_tpu_torch.tools.analysis_tools.analyze_logs \\
        plot_curve RUN.log.json [..] --keys loss mAP --out curve.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gkgnet_tpu_torch.utils.logging import load_json_log


def cal_train_time(log_dict) -> dict[int, tuple]:
    """Prints, and returns, each epoch's (mean, min, max) seconds between
    consecutive train records."""
    windows = {}
    for epoch, bucket in sorted(log_dict.items()):
        times = bucket.get("time", [])
        if len(times) < 2:
            continue
        deltas = np.diff(times)
        windows[epoch] = (deltas.mean(), deltas.min(), deltas.max())
        print(f"epoch {epoch}: avg iter window {deltas.mean():.4f}s "
              f"min {deltas.min():.4f} max {deltas.max():.4f}")
    return windows


def plot_curve(log_dicts, args) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for log_dict, path in zip(log_dicts, args.json_logs):
        for key in args.keys:
            xs, ys = [], []
            for epoch, bucket in sorted(log_dict.items()):
                vals = bucket.get(key, [])
                iters = bucket.get("iter", list(range(len(vals))))
                for it, v in zip(iters, vals):
                    xs.append((epoch - 1) * (max(iters) if iters else 1) + it)
                    ys.append(v)
            if xs:
                plt.plot(xs, ys, label=f"{os.path.basename(path)}:{key}")
    plt.legend()
    plt.xlabel("iter")
    plt.savefig(args.out or "curve.png", dpi=150)
    print(f"saved {args.out or 'curve.png'}")


def main(argv=None) -> list[dict]:
    """Returns the loaded logs."""
    p = argparse.ArgumentParser(description="Analyze training logs")
    sub = p.add_subparsers(dest="task", required=True)
    pc = sub.add_parser("plot_curve")
    pc.add_argument("json_logs", nargs="+")
    pc.add_argument("--keys", nargs="+", default=["loss"])
    pc.add_argument("--out", default=None)
    ct = sub.add_parser("cal_train_time")
    ct.add_argument("json_logs", nargs="+")
    args = p.parse_args(argv)

    log_dicts = [load_json_log(path) for path in args.json_logs]
    if args.task == "cal_train_time":
        for d in log_dicts:
            cal_train_time(d)
    else:
        plot_curve(log_dicts, args)
    return log_dicts


if __name__ == "__main__":
    main()
