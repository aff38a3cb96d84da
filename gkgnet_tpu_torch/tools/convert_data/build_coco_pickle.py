"""Build the COCO multi-label pickle annotation file from a standard
``instances_*.json`` (counterpart: ``tools/convert_data/build_coco_pickle.py``,
a copy): a pickled list of ``{"objects": multi-hot (80,) int8,
"file_name": str}`` records, the format ``data/coco.py`` reads, with
``--with-area`` each class's largest object area as ``"area"``.

    python -m gkgnet_tpu_torch.tools.convert_data.build_coco_pickle \\
        instances_train2014.json train.data [--with-area]
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np


def build_records(coco: dict, with_area: bool = False) -> list[dict]:
    """One record per image of an instances dict, in its image order."""
    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}
    n_classes = len(cat_ids)
    per_image: dict[int, np.ndarray] = {}
    per_image_area: dict[int, np.ndarray] = {}
    for ann in coco["annotations"]:
        img_id = ann["image_id"]
        ci = cat_to_idx[ann["category_id"]]
        vec = per_image.setdefault(
            img_id, np.zeros(n_classes, dtype=np.int8))
        vec[ci] = 1
        if with_area:
            areas = per_image_area.setdefault(
                img_id, np.zeros(n_classes, dtype=np.float64))
            areas[ci] = max(areas[ci], float(ann.get("area", 0)))

    records = []
    for img in coco["images"]:
        rec = {
            "objects": per_image.get(
                img["id"], np.zeros(n_classes, dtype=np.int8)),
            "file_name": img["file_name"],
        }
        if with_area:
            rec["area"] = per_image_area.get(
                img["id"], np.zeros(n_classes, dtype=np.float64))
        records.append(rec)
    return records


def main(argv=None) -> list[dict]:
    """Returns the records written."""
    p = argparse.ArgumentParser(description="COCO instances -> pickle")
    p.add_argument("instances_json", help="e.g. instances_train2014.json")
    p.add_argument("out", help="e.g. train.data")
    p.add_argument("--with-area", action="store_true",
                   help="also store per-class max object area (for mAP_area)")
    args = p.parse_args(argv)

    with open(args.instances_json) as f:
        coco = json.load(f)
    print(f"{len(coco['categories'])} categories, {len(coco['images'])} "
          f"images, {len(coco['annotations'])} annotations")
    records = build_records(coco, args.with_area)
    with open(args.out, "wb") as f:
        pickle.dump(records, f)
    n_pos = sum(int(r["objects"].sum()) for r in records)
    print(f"wrote {len(records)} records ({n_pos} positive labels) -> "
          f"{args.out}")
    return records


if __name__ == "__main__":
    main()
