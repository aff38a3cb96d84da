"""Label->patch edges (counterpart: ``tools/visualizations/vis_edges.py``):
for each class drawn, the stage-4 patches that its label token reaches
through the last label GCN's k-NN, outlined on the input image.

    python -m gkgnet_tpu_torch.tools.visualizations.vis_edges IMG CONFIG \\
        [CKPT_DIR] [--classes 0 14] [--out edges.png] [--device cpu]

The scores and edges are the eval forward's own (the config's test
pipeline, the model in eval mode). The class names come from the config's
test dataset type (``VOC_CLASSES`` for VOC, ``COCO_CLASSES`` for COCO, an
ImageList's ``classes``); the JAX tool names every class from COCO. Runs on
the card unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image, ImageDraw

from gkgnet_tpu_torch.core.builder import DATASETS
from gkgnet_tpu_torch.tools.inference import image_batch, init_model

COLORS = [(255, 64, 64), (64, 255, 64), (64, 128, 255), (255, 255, 0)]


def class_names(cfg) -> list | None:
    """The class names of the config's test dataset, or None."""
    ds = cfg.data["test"]
    while "dataset" in ds:  # a wrapper's inner dataset
        ds = ds["dataset"]
    if ds.get("classes"):
        return list(ds["classes"])
    return getattr(DATASETS.get(ds["type"]), "CLASSES", None)


@torch.no_grad()
def scores_and_edges(model, cfg, img_path: str
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The eval forward on one image: the sigmoid scores (n_classes,) and
    the last label GCN's edge_index (num_group, n_classes, k), indices into
    the stage-4 grid."""
    score, edges = model.eval()(image_batch(model, cfg, img_path))
    return (torch.sigmoid(score.float())[0].cpu().numpy(),
            edges.cpu().numpy())


def draw_edges(img_path: str, size: int, scores: np.ndarray,
               edges: np.ndarray, class_ids, names):
    """The image at ``size``, each class's patches outlined in its color,
    its name and score written at the top left. Returns a PIL image."""
    grid = size // 32  # stage-4 resolution
    with Image.open(img_path) as im:
        im = im.convert("RGB").resize((size, size))
    draw = ImageDraw.Draw(im)
    cell = size // grid
    for ci, cls in enumerate(class_ids):
        color = COLORS[ci % len(COLORS)]
        for gidx in range(edges.shape[0]):
            for patch in edges[gidx, cls]:
                r, c = divmod(int(patch), grid)
                draw.rectangle([c * cell, r * cell, (c + 1) * cell,
                                (r + 1) * cell], outline=color, width=2)
        name = names[cls] if names and cls < len(names) else str(cls)
        draw.text((4, 4 + 14 * ci), f"{name}: {scores[cls]:.3f}", fill=color)
    return im


def main(argv=None) -> dict:
    """Returns ``{'scores', 'edges', 'class_ids', 'names', 'out'}``."""
    p = argparse.ArgumentParser(description="Draw label->patch edges")
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--classes", type=int, nargs="+", default=None,
                   help="class ids to draw (default: top-3 predictions)")
    p.add_argument("--out", default="edges.png")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model, cfg = init_model(args.config, args.checkpoint, args.device)
    scores, edges = scores_and_edges(model, cfg, args.img)
    class_ids = args.classes or [int(c) for c in np.argsort(-scores)[:3]]
    names = class_names(cfg)
    draw_edges(args.img, cfg.model["size"], scores, edges, class_ids,
               names).save(args.out)
    print(f"saved {args.out} (classes {class_ids})")
    return dict(scores=scores, edges=edges, class_ids=class_ids,
                names=names, out=args.out)


if __name__ == "__main__":
    main()
