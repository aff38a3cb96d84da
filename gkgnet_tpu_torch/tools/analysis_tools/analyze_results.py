"""Best and worst predictions of a dumped results file (counterpart:
``tools/analysis_tools/analyze_results.py``): ranks the test split's images
by per-image quality (the share of classes right at threshold 0.5) and
writes the ``--topk`` worst and best to a JSON file, with the JAX tool's
keys. No model, no card.

    python -m gkgnet_tpu_torch.tools.analysis_tools.analyze_results CONFIG \\
        scores.pkl [--topk 20] [--out analysis.json] [--cfg-options k=v ..]
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from gkgnet_tpu_torch.core.builder import build_dataset
from gkgnet_tpu_torch.tools.train import load_config


def analyze(ds, scores: np.ndarray, topk: int) -> tuple[dict, float]:
    """``({'worst': [...], 'best': [...]}, mean quality)`` for a dataset
    and its (N, C) scores."""
    gt = ds.get_gt_labels().astype(np.float64)
    pred = (scores >= 0.5).astype(np.float64)
    quality = (pred == gt).mean(axis=1)
    order = np.argsort(quality)
    classes = list(getattr(ds, "CLASSES", None) or [])

    def names(ids):
        return [classes[c] if classes else c for c in ids]

    def describe(i):
        i = int(i)
        return {"index": i,
                "file": ds.data_infos[i]["img_info"]["filename"]
                if hasattr(ds, "data_infos") else None,
                "quality": float(quality[i]),
                "gt": names(np.where(gt[i] == 1)[0]),
                "hits": names(np.where((pred[i] == 1) & (gt[i] == 1))[0]),
                "false_positives": names(
                    np.where((pred[i] == 1) & (gt[i] == 0))[0])}

    report = {"worst": [describe(i) for i in order[:topk]],
              "best": [describe(i) for i in order[::-1][:topk]]}
    return report, float(quality.mean())


def main(argv=None) -> dict:
    """Returns the report (also written to ``--out``)."""
    p = argparse.ArgumentParser(description="Rank a --out file's images")
    p.add_argument("config")
    p.add_argument("results", help="pickle of (N, C) scores")
    p.add_argument("--topk", type=int, default=20)
    p.add_argument("--out", default="analysis.json")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.cfg_options)
    with open(args.results, "rb") as f:
        scores = np.asarray(pickle.load(f))
    report, mean_quality = analyze(build_dataset(cfg.data["test"]), scores,
                                   args.topk)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"mean per-image quality {mean_quality:.4f}; report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
