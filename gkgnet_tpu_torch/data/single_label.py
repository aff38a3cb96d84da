"""Single-label datasets (counterpart: ``gkgnet_tpu/data/single_label.py``,
a copy; the reference inherits mmcls's BaseDataset family;
GKGNet's live path is multi-label COCO, but the single-label API —
accuracy/precision/recall/f1/support evaluation, base_dataset.py:15-213 — is
part of the surface)."""

from __future__ import annotations

import os

import numpy as np


class ImageListDataset:
    """Images + integer labels from an annotation file with
    ``<relative_path> <label>`` lines (mmcls ImageNet/custom format)."""

    CLASSES: list[str] | None = None

    def __init__(self, data_prefix: str, ann_file: str, pipeline=None,
                 classes=None, test_mode: bool = False):
        self.data_prefix = data_prefix
        self.pipeline = pipeline
        self.test_mode = test_mode
        if classes is not None:
            self.CLASSES = list(classes)
        self.data_infos = []
        with open(ann_file) as f:
            for line in f:
                if not line.strip():
                    continue
                name, label = line.rsplit(maxsplit=1)
                self.data_infos.append(dict(
                    img_prefix=data_prefix,
                    img_info=dict(filename=name),
                    gt_label=np.int64(label),
                ))

    def __len__(self):
        return len(self.data_infos)

    def get_gt_labels(self) -> np.ndarray:
        return np.array([d["gt_label"] for d in self.data_infos])

    def get_cat_ids(self, idx: int) -> list[int]:
        return [int(self.data_infos[idx]["gt_label"])]

    def prepare_data(self, idx: int, rng=None):
        results = {
            "img_prefix": self.data_infos[idx]["img_prefix"],
            "img_info": dict(self.data_infos[idx]["img_info"]),
            "gt_label": self.data_infos[idx]["gt_label"],
        }
        if self.pipeline is not None:
            results = self.pipeline(results, rng)
        return results

    def __getitem__(self, idx):
        return self.prepare_data(idx)

    def filepath(self, idx: int) -> str:
        return os.path.join(self.data_prefix,
                            self.data_infos[idx]["img_info"]["filename"])

    def evaluate(self, results, metric="accuracy", metric_options=None,
                 logger=None) -> dict:
        """Single-label metric family (base_dataset.py evaluate: accuracy /
        precision / recall / f1_score / support, topk/thrs options)."""
        from gkgnet_tpu_torch.core import metrics as M

        if metric_options is None:
            metric_options = {"topk": (1, 5)}
        metrics = [metric] if isinstance(metric, str) else list(metric)
        results = np.vstack(results)
        gt = self.get_gt_labels()
        num_classes = results.shape[1]
        out = {}
        if "accuracy" in metrics:
            topk = metric_options.get("topk", (1, 5))
            topk = tuple(k for k in topk if k <= num_classes)
            accs = M.accuracy(results, gt, topk)
            out.update({f"accuracy_top-{k}": a for k, a in zip(topk, accs)})
        if any(m in metrics for m in ("precision", "recall", "f1_score")):
            p, r, f1 = M.precision_recall_f1(
                results, gt, metric_options.get("average_mode", "macro"))
            if "precision" in metrics:
                out["precision"] = p
            if "recall" in metrics:
                out["recall"] = r
            if "f1_score" in metrics:
                out["f1_score"] = f1
        if "support" in metrics:
            out["support"] = int(M.support(gt, num_classes).sum())
        if logger is not None:
            logger.info(out)
        return out
