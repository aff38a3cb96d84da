"""Re-evaluate a dumped results file offline (counterpart:
``tools/analysis_tools/eval_metric.py``): the pickle that the test CLI's
``--out`` writes goes in, the config's test dataset's ``evaluate`` dict
comes out as JSON. No model, no card.

    python -m gkgnet_tpu_torch.tools.analysis_tools.eval_metric CONFIG \\
        scores.pkl [--cfg-options k=v ..]
"""

from __future__ import annotations

import argparse
import json
import pickle

from gkgnet_tpu_torch.core.builder import build_dataset
from gkgnet_tpu_torch.tools.train import load_config


def main(argv=None) -> dict:
    """Returns the metric dict (also printed as JSON)."""
    p = argparse.ArgumentParser(description="Re-score a --out file")
    p.add_argument("config")
    p.add_argument("results", help="pickle of (N, C) scores from test --out")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.cfg_options)
    with open(args.results, "rb") as f:
        results = pickle.load(f)
    metrics = build_dataset(cfg.data["test"]).evaluate(results)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
