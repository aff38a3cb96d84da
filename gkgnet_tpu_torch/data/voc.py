"""PASCAL VOC multi-label dataset (counterpart: ``gkgnet_tpu/data/voc.py``,
a copy).

The reference repo ships no VOC loader, but its paper reports PASCAL-VOC
2007 SOTA (reference README.md:2-7) and the fine-tune recipe is a target
config of this framework (GKGNet-S @448 on VOC2007). This loader follows
the upstream MMClassification VOC semantics the reference forked from:

  * 20 classes, standard VOCdevkit layout
    (``ImageSets/Main/<split>.txt`` + ``Annotations/<id>.xml`` +
    ``JPEGImages/<id>.jpg``).
  * A class whose only instances in an image are marked ``difficult`` gets
    label ``-1``; metrics exclude -1 from the AP ranking denominator
    (reference mmcls/core/evaluation/mean_ap.py:6-44) and training maps it
    to positive via abs (reference mmcls/models/heads/multi_label_head.py:
    "abs(gt_label) maps difficult(-1)->positive").
  * ``evaluate`` emits the multi-label dict (mAP percent +
    CP/CR/CF1/OP/OR/OF1), reference mmcls/datasets/multi_label.py:36-87.

A pickled annotation list in the COCO-pickle shape
(``{"objects": (20,), "file_name": str}``) is also accepted so converted /
synthetic datasets can reuse the same path.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET

import numpy as np

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


class VOCMultiLabel:
    """PASCAL VOC multi-label dataset (XML annotations or pickle)."""

    CLASSES = VOC_CLASSES

    def __init__(self, data_prefix: str, ann_file: str, pipeline=None,
                 test_mode: bool = False, difficult_as_positive: bool = True):
        self.data_prefix = data_prefix
        self.ann_file = ann_file
        self.pipeline = pipeline
        self.test_mode = test_mode
        self.difficult_as_positive = difficult_as_positive
        self.class_to_idx = {c: i for i, c in enumerate(self.CLASSES)}
        self.data_infos = self.load_annotations()

    # ------------------------------------------------------------- loading

    def _parse_xml(self, xml_path: str) -> np.ndarray:
        """Multi-hot (20,) in {-1, 0, 1}; -1 = only-difficult instances."""
        labels, difficult = set(), set()
        root = ET.parse(xml_path).getroot()
        for obj in root.findall("object"):
            name = obj.find("name")
            if name is None or name.text not in self.class_to_idx:
                continue
            idx = self.class_to_idx[name.text]
            diff_node = obj.find("difficult")
            is_difficult = diff_node is not None and int(diff_node.text) == 1
            if is_difficult:
                difficult.add(idx)
            else:
                labels.add(idx)
        gt = np.zeros(len(self.CLASSES), dtype=np.int8)
        gt[list(difficult - labels)] = -1
        gt[list(labels)] = 1
        return gt

    def load_annotations(self):
        if self.ann_file.endswith((".data", ".pkl", ".pickle")):
            with open(self.ann_file, "rb") as f:
                records = pickle.load(f)
            return [dict(
                img_prefix=self.data_prefix,
                img_info=dict(filename=rec["file_name"]),
                gt_label=np.asarray(rec["objects"]).astype(np.int8),
            ) for rec in records]

        with open(self.ann_file) as f:
            ids = [line.split()[0] for line in f if line.strip()]
        infos = []
        for img_id in ids:
            xml_path = os.path.join(self.data_prefix, "Annotations",
                                    f"{img_id}.xml")
            infos.append(dict(
                img_prefix=os.path.join(self.data_prefix, "JPEGImages"),
                img_info=dict(filename=f"{img_id}.jpg"),
                gt_label=self._parse_xml(xml_path),
            ))
        return infos

    # ------------------------------------------------------------ protocol

    def __len__(self):
        return len(self.data_infos)

    def get_gt_labels(self) -> np.ndarray:
        return np.array([d["gt_label"] for d in self.data_infos])

    def get_cat_ids(self, idx: int) -> list[int]:
        return np.where(self.data_infos[idx]["gt_label"] == 1)[0].tolist()

    def prepare_data(self, idx: int, rng: np.random.Generator | None = None):
        gt = self.data_infos[idx]["gt_label"].copy()
        if not self.test_mode and self.difficult_as_positive:
            gt = np.abs(gt)
        results = {
            "img_prefix": self.data_infos[idx]["img_prefix"],
            "img_info": dict(self.data_infos[idx]["img_info"]),
            "gt_label": gt,
        }
        if self.pipeline is not None:
            results = self.pipeline(results, rng)
        return results

    def __getitem__(self, idx: int):
        return self.prepare_data(idx)

    def filepath(self, idx: int) -> str:
        return os.path.join(self.data_infos[idx]["img_prefix"],
                            self.data_infos[idx]["img_info"]["filename"])

    def evaluate(self, results, metric="mAP", logger=None) -> dict:
        """Multi-label evaluate (multi_label.py:36-87): mAP percent with
        difficult handling + CP/CR/CF1/OP/OR/OF1 at thr=0.5."""
        from gkgnet_tpu_torch.core.metrics import (average_performance,
                                                   mAP_mmcls)

        results = np.vstack(results)
        gt = self.get_gt_labels()
        assert len(gt) == len(results)
        cp, cr, cf1, op, orr, of1 = average_performance(results, gt, thr=0.5)
        record = {
            "mAP": round(mAP_mmcls(results, gt), 4),
            "CP": round(cp, 4), "CR": round(cr, 4), "CF1": round(cf1, 4),
            "OP": round(op, 4), "OR": round(orr, 4), "OF1": round(of1, 4),
        }
        if logger is not None:
            logger.info(record)
        return record
