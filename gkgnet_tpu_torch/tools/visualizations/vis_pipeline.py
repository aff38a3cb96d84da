"""Augmented samples of a split (counterpart:
``tools/visualizations/vis_pipeline.py``): the split's pipeline, without
its Normalize, on the first ``--number`` images, saved as a grid of 4
columns. Each sample's draws are seeded from ``(--seed, index)``.

    python -m gkgnet_tpu_torch.tools.visualizations.vis_pipeline CONFIG \\
        [--split train] [--number 8] [--out pipeline_samples.png]
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from gkgnet_tpu_torch.core.builder import build_dataset
from gkgnet_tpu_torch.tools.train import load_config


def samples(ds_cfg: dict, number: int, seed: int) -> list[np.ndarray]:
    """The first ``number`` samples of the split, uint8 (H, W, 3), through
    its pipeline without Normalize (found through dataset wrappers)."""
    ds_cfg = dict(ds_cfg)
    inner = ds_cfg
    while "pipeline" not in inner and "dataset" in inner:
        inner["dataset"] = dict(inner["dataset"])
        inner = inner["dataset"]
    inner["pipeline"] = [c for c in inner["pipeline"]
                         if c["type"] != "Normalize"]
    ds = build_dataset(ds_cfg)
    imgs = []
    for i in range(min(number, len(ds))):
        img = ds.prepare_data(i, np.random.default_rng((seed, i)))["img"]
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        imgs.append(img)
    return imgs


def grid(imgs: list[np.ndarray], cols: int = 4) -> np.ndarray:
    """The images left-top aligned in cells of the largest one's size."""
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    cols = min(cols, len(imgs))
    rows = -(-len(imgs) // cols)
    out = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, cols)
        out[r * h:r * h + img.shape[0], c * w:c * w + img.shape[1]] = img
    return out


def main(argv=None) -> np.ndarray:
    """Returns the grid (also saved to ``--out``)."""
    p = argparse.ArgumentParser(description="Save augmented samples")
    p.add_argument("config")
    p.add_argument("--split", default="train")
    p.add_argument("--number", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="pipeline_samples.png")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.cfg_options)
    imgs = samples(cfg.data[args.split], args.number, args.seed)
    out = grid(imgs)
    Image.fromarray(out).save(args.out)
    print(f"saved {len(imgs)} samples -> {args.out}")
    return out


if __name__ == "__main__":
    main()
