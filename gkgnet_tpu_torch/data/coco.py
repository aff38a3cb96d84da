"""MS-COCO multi-label dataset (counterpart: ``gkgnet_tpu/data/coco.py``, a
copy; reference datasets/coco.py).

Annotation format: a pickled list of ``{"objects": multi-hot (80,),
"file_name": str}`` dicts (coco.py:269-291). ``evaluate`` always emits the
full COCO metric dict (mAP + CP/CR/CF1/OP/OR/OF1 at thr 0.5 and top-3,
coco.py:301-330).

``tools/convert_data/build_coco_pickle.py`` builds this pickle from a
standard ``instances_*.json``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


class CocoMultiLabel:
    """Multi-label COCO over the reference's pickle annotation format."""

    CLASSES = COCO_CLASSES

    def __init__(self, data_prefix: str, ann_file: str, pipeline=None,
                 test_mode: bool = False):
        self.data_prefix = data_prefix
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.data_infos = self.load_annotations()

    def load_annotations(self):
        with open(self.ann_file, "rb") as f:
            coco_data = pickle.load(f)
        infos = []
        for rec in coco_data:
            infos.append(dict(
                img_prefix=self.data_prefix,
                img_info=dict(filename=rec["file_name"]),
                gt_label=np.asarray(rec["objects"]).astype(np.int8),
            ))
        return infos

    def __len__(self):
        return len(self.data_infos)

    def get_gt_labels(self) -> np.ndarray:
        return np.array([d["gt_label"] for d in self.data_infos])

    def get_cat_ids(self, idx: int) -> list[int]:
        """Category ids of one sample (multi_label.py:24-35)."""
        return np.where(self.data_infos[idx]["gt_label"] == 1)[0].tolist()

    def prepare_data(self, idx: int, rng: np.random.Generator | None = None):
        results = {
            "img_prefix": self.data_infos[idx]["img_prefix"],
            "img_info": dict(self.data_infos[idx]["img_info"]),
            "gt_label": self.data_infos[idx]["gt_label"].copy(),
        }
        if self.pipeline is not None:
            results = self.pipeline(results, rng)
        return results

    def __getitem__(self, idx: int):
        return self.prepare_data(idx)

    def filepath(self, idx: int) -> str:
        return os.path.join(self.data_prefix,
                            self.data_infos[idx]["img_info"]["filename"])

    def evaluate(self, results, metric: str = "accuracy", logger=None) -> dict:
        """results: (N, 80) sigmoid scores (list or array). Ignores the
        requested metric and emits the full dict, as the reference does
        (coco.py:301-330)."""
        from gkgnet_tpu_torch.core.metrics import coco_metrics

        results = np.vstack(results)
        gt = self.get_gt_labels()
        assert len(gt) == len(results)
        record = coco_metrics(gt, results, threshold=0.5)
        if logger is not None:
            logger.info(record)
        return record
