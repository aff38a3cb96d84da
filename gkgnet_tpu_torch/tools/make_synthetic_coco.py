#!/usr/bin/env python
"""Generate a LEARNABLE synthetic multi-label COCO-format dataset
(counterpart: ``tools/make_synthetic_coco.py``, a copy: the same seeds give
the same pixels and pickle).

Each of the 80 classes is a visual signal the network can actually
learn: a class-specific colored shape at a class-specific grid position
over a random-texture background. Images carry 1-4 classes; annotations
are the framework's pickle format (list of {"objects": int8[80],
"file_name"}).

Usage:
  python -m gkgnet_tpu_torch.tools.make_synthetic_coco OUT_DIR [--train 256] [--val 64]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
from PIL import Image, ImageDraw


def class_style(c: int):
    """Deterministic per-class (position, color, shape)."""
    rs = np.random.default_rng(1000 + c)
    row, col = divmod(c, 10)               # 8 x 10 grid
    color = tuple(int(v) for v in rs.integers(60, 256, 3))
    shape = ("rect", "ellipse", "cross")[c % 3]
    return row, col, color, shape


def render(rng: np.random.Generator, classes, size=480) -> Image.Image:
    img = Image.fromarray(
        rng.integers(0, 80, (size, size, 3), dtype=np.uint8))
    d = ImageDraw.Draw(img)
    cell_h, cell_w = size // 8, size // 10
    for c in classes:
        row, col, color, shape = class_style(int(c))
        # jittered placement inside the class's cell keeps the signal
        # position-specific yet crop/flip-augmentable
        jx = int(rng.integers(-cell_w // 4, cell_w // 4 + 1))
        jy = int(rng.integers(-cell_h // 4, cell_h // 4 + 1))
        x0 = col * cell_w + cell_w // 6 + jx
        y0 = row * cell_h + cell_h // 6 + jy
        x1, y1 = x0 + 2 * cell_w // 3, y0 + 2 * cell_h // 3
        if shape == "rect":
            d.rectangle((x0, y0, x1, y1), fill=color)
        elif shape == "ellipse":
            d.ellipse((x0, y0, x1, y1), fill=color)
        else:
            d.line((x0, y0, x1, y1), fill=color, width=7)
            d.line((x0, y1, x1, y0), fill=color, width=7)
    return img


def make_split(out_dir, ann_path, n, seed):
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        # guarantee coverage: image i always contains class i % 80, plus
        # 0-3 random extras (a class with zero positives pins its AP to 0
        # by the reference mAP definition regardless of learning)
        classes = {i % 80}
        classes.update(rng.choice(80, size=int(rng.integers(0, 4)),
                                  replace=False).tolist())
        img = render(rng, sorted(classes))
        name = f"syn_{i:05d}.jpg"
        img.save(os.path.join(out_dir, name), quality=92)
        objects = np.zeros(80, np.int8)
        objects[sorted(classes)] = 1
        records.append({"objects": objects, "file_name": name})
    with open(ann_path, "wb") as f:
        pickle.dump(records, f)
    return len(records)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out")
    p.add_argument("--train", type=int, default=256)
    p.add_argument("--val", type=int, default=64)
    args = p.parse_args(argv)
    n_tr = make_split(os.path.join(args.out, "train"),
                      os.path.join(args.out, "train.data"), args.train, 0)
    n_va = make_split(os.path.join(args.out, "val"),
                      os.path.join(args.out, "val.data"), args.val, 1)
    print(f"wrote {n_tr} train / {n_va} val images under {args.out}")


if __name__ == "__main__":
    main()
