"""Decode every image of a config's split to find corrupt files
(counterpart: ``tools/misc/verify_dataset.py``), in a thread pool. Works on
every dataset type (COCO, VOC, ImageList) and through dataset wrappers.
Exits 1 and writes the bad files to ``--out`` when there are any.

    python -m gkgnet_tpu_torch.tools.misc.verify_dataset CONFIG \\
        [--split train] [--workers 16] [--out broken_files.txt]
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from gkgnet_tpu_torch.core.builder import build_dataset
from gkgnet_tpu_torch.tools.train import load_config


def check_image(path: str) -> str | None:
    """None if the file decodes to RGB, else ``path<TAB>error``."""
    try:
        with Image.open(path) as im:
            np.asarray(im.convert("RGB"))
        return None
    except Exception as e:  # any decode failure is a finding, not a crash
        return f"{path}\t{type(e).__name__}: {e}"


def main(argv=None) -> list[str]:
    """Returns the bad files (``path<TAB>error`` lines)."""
    p = argparse.ArgumentParser(description="Decode every image of a split")
    p.add_argument("config")
    p.add_argument("--split", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--out", default="broken_files.txt")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = load_config(args.config, args.cfg_options)
    ds_cfg = dict(cfg.data[args.split])
    ds_cfg["pipeline"] = None
    base = build_dataset(ds_cfg)
    while not hasattr(base, "filepath"):  # through the wrappers
        base = base.dataset

    broken = []
    with ThreadPoolExecutor(args.workers) as pool:
        for i, res in enumerate(pool.map(lambda i: check_image(
                base.filepath(i)), range(len(base)))):
            if res:
                broken.append(res)
            if (i + 1) % 1000 == 0:
                print(f"{i + 1}/{len(base)} checked, {len(broken)} broken")
    if broken:
        with open(args.out, "w") as f:
            f.write("\n".join(broken))
        print(f"{len(broken)} broken files -> {args.out}")
    else:
        print(f"all {len(base)} images decodable")
    return broken


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
