"""Per-transform cost profile of the host data path (counterpart:
``tools/profile_loader.py``).

Measures, on this machine's cores (no card involved):
  1. per-transform ms per sample over the 576 train stack (``PIPE_CFG``),
     JPEG decode included, on synthetic 640x480 JPEGs written from a seed;
  2. a finer split of CropMixup (decode-free): the views (PIL crop and
     resize) against the native blend chain;
  3. loader img/s at 1, 2 and 4 workers, threads against processes
     (``data.loader.build_dataloader``, batch 8).

    python -m gkgnet_tpu_torch.tools.profile_loader [--quick] [--skip-e2e]
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
from PIL import Image

from gkgnet_tpu_torch.data.coco import CocoMultiLabel
from gkgnet_tpu_torch.data.loader import build_dataloader
from gkgnet_tpu_torch.data.pipelines import CropMixup, build_pipeline
from gkgnet_tpu_torch.native import mix_chain

PIPE_CFG = [
    dict(type="LoadImageFromFile"),
    dict(type="CropMixup", size=576, p=0.5),
    dict(type="RandomFlip", flip_prob=0.5),
    dict(type="RandomErasing", erase_prob=0.2),
    dict(type="ColorJitter", brightness=0.4, contrast=0.4, saturation=0.4),
    dict(type="Trivial"),
    dict(type="Normalize",
         mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
    dict(type="Collect", keys=["img", "gt_label"]),
]


def make_fixture(tmp: str, n_img: int = 64) -> str:
    """n_img seeded 640x480 JPEGs (quality 90) with 3-hot labels and their
    annotation pickle in tmp; returns the pickle's path."""
    rng = np.random.default_rng(0)
    ann = []
    for i in range(n_img):
        arr = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
        name = f"im{i}.jpg"
        Image.fromarray(arr).save(os.path.join(tmp, name), quality=90)
        objs = np.zeros(80, np.float32)
        objs[rng.integers(0, 80, 3)] = 1
        ann.append({"file_name": name, "objects": objs})
    ann_file = os.path.join(tmp, "ann.pkl")
    with open(ann_file, "wb") as f:
        pickle.dump(ann, f)
    return ann_file


def per_transform(tmp: str, ann_file: str, n_samples: int) -> dict:
    """The pipeline sample by sample on one thread, each transform timed;
    returns {transform: (mean ms, p90 ms)} and the total."""
    pipeline = build_pipeline(PIPE_CFG)
    with open(ann_file, "rb") as f:
        ann = pickle.load(f)
    names = [c["type"] for c in PIPE_CFG]
    ms = np.zeros((n_samples, len(pipeline.transforms)))
    for s in range(n_samples):
        rng = np.random.default_rng((0, 0, s))
        info = ann[s % len(ann)]
        results = {"img_prefix": tmp,
                   "img_info": dict(filename=info["file_name"]),
                   "gt_label": np.asarray(info["objects"], np.float32)}
        for i, t in enumerate(pipeline.transforms):
            t0 = time.perf_counter()
            results = t(results, rng=rng)
            ms[s, i] = (time.perf_counter() - t0) * 1e3
    tot = ms.sum()
    print(f"\n-- per-transform cost ({n_samples} samples, 640x480 JPEG "
          f"-> 576² train stack, single thread) --")
    print(f"  {'transform':20s} {'mean ms':>8s} {'p90 ms':>8s} {'share':>6s}")
    out = {}
    for i, name in enumerate(names):
        col = ms[:, i]
        out[name] = (float(col.mean()), float(np.percentile(col, 90)))
        print(f"  {name:20s} {col.mean():8.2f} {np.percentile(col, 90):8.2f} "
              f"{100 * col.sum() / tot:5.1f}%")
    per_sample = tot / n_samples
    print(f"  {'TOTAL':20s} {per_sample:8.2f}  -> "
          f"{1e3 / per_sample:.1f} img/s/core")
    return dict(transforms=out, total_ms=float(per_sample))


def cropmix_split(tmp: str, n_samples: int) -> dict:
    """CropMixup at p=1 (uint8 views, the native blend chain): the views
    (n x PIL crop + resize) against the blend; ms per sample of each."""
    cm = CropMixup(p=1.0, size=576)
    img = np.asarray(Image.open(os.path.join(tmp, "im0.jpg")).convert("RGB"))
    t_views = t_blend = 0.0
    for s in range(n_samples):
        rng = np.random.default_rng((1, s))
        n = int(rng.choice([2, 3, 4]))
        t0 = time.perf_counter()
        views = cm._views(img, n, rng)
        t1 = time.perf_counter()
        order = rng.permutation(n)
        plan = []
        for _ in order[1:]:
            lam = float(rng.beta(cm.mix_ratio / n, cm.mix_ratio / n))
            perm = rng.permutation(3)
            plan.append((lam, 1 if lam > 0.5 else 2, *map(int, perm)))
        mix_chain([views[i] for i in order], plan)
        t2 = time.perf_counter()
        t_views += t1 - t0
        t_blend += t2 - t1
    views_ms = t_views / n_samples * 1e3
    blend_ms = t_blend / n_samples * 1e3
    print(f"\n-- CropMixup split ({n_samples} samples, p=1, mean n=3) --")
    print(f"  views (n x PIL crop+resize):      {views_ms:7.2f} ms")
    print(f"  fused native blend chain + store: {blend_ms:7.2f} ms")
    return dict(views_ms=views_ms, blend_ms=blend_ms)


def end_to_end(tmp: str, ann_file: str, batch: int = 8,
               epochs: int = 3) -> dict:
    """Loader img/s over ``epochs`` epochs after a warmup epoch (the
    process pool's start, the caches), per worker count and mode."""
    ds = CocoMultiLabel(ann_file=ann_file, data_prefix=tmp,
                        pipeline=build_pipeline(PIPE_CFG))
    print(f"\n-- end-to-end loader img/s (batch {batch}) --")
    out = {}
    for n_workers in (1, 2, 4):
        for mode in ("threads", "processes"):
            loader = build_dataloader(ds, batch, n_workers, num_replicas=1,
                                      rank=0, shuffle=True, seed=0,
                                      drop_last=True, mode=mode)
            try:
                loader.set_epoch(0)
                for _ in loader:  # warmup
                    pass
                t0 = time.perf_counter()
                n = 0
                for e in range(1, 1 + epochs):
                    loader.set_epoch(e)
                    for b in loader:
                        n += b["img"].shape[0]
                rate = n / (time.perf_counter() - t0)
            finally:
                loader.close()
            out[(n_workers, mode)] = rate
            print(f"  workers={n_workers} {mode:10s}: {rate:7.1f} img/s",
                  flush=True)
    return out


def main(argv=None) -> dict:
    """Returns ``{'per_transform', 'cropmix', 'loader'}`` (the last
    without ``--skip-e2e`` only)."""
    p = argparse.ArgumentParser(description="host data path profile")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--skip-e2e", action="store_true")
    args = p.parse_args(argv)
    n = 48 if args.quick else 160
    print(f"host: {os.cpu_count()} cores", flush=True)
    tmp = tempfile.mkdtemp(prefix="profile_loader_")
    try:
        ann_file = make_fixture(tmp)
        out = dict(per_transform=per_transform(tmp, ann_file, n),
                   cropmix=cropmix_split(tmp, max(24, n // 4)))
        if not args.skip_e2e:
            out["loader"] = end_to_end(tmp, ann_file,
                                       epochs=2 if args.quick else 3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
