"""Host-side transform pipeline (counterpart: ``gkgnet_tpu/data/pipelines.py``;
reference datasets/pipelines/*). A copy: every transform draws what the JAX
package's draws, in the same order, so both give the same bytes.

Every transform is ``__call__(results: dict, rng: np.random.Generator)`` —
all randomness flows through an explicit generator so per-sample seeds give
bitwise-reproducible pipelines on every host (the reference seeds global
``np.random``/``random`` per worker, builder.py:148-161).

Images are RGB uint8 HWC throughout (the reference loads BGR via cv2 and
flips to RGB in Normalize; same math, one less conversion), become float32
at Normalize, and stay HWC (the model's NHWC layout — no ``ImageToTensor``
CHW transpose).

Live train pipeline (configs/gkgnet/gkgnet_coco_576.py:45-65):
CropMixup(p=.5) -> RandomFlip -> RandomErasing(rand, fill mean/std) ->
ColorJitter(.4,.4,.4) -> Trivial -> Normalize; test: Resize(576, bicubic)
-> Normalize.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image

from gkgnet_tpu_torch.data.trivial_augment import (AutoAugment, RandAugment,
                                                   TrivialAugment,
                                                   UniAugment,
                                                   UniAugmentWeighted,
                                                   _cutout)
from gkgnet_tpu_torch.native import color_jitter, mix_chain, normalize_u8

PIL_INTERP = {
    "nearest": Image.NEAREST,
    "bilinear": Image.BILINEAR,
    "bicubic": Image.BICUBIC,
    "box": Image.BOX,
    "lanczos": Image.LANCZOS,
    "hamming": Image.HAMMING,
}

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _ensure_rng(rng):
    return rng if rng is not None else np.random.default_rng()


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results: dict, rng=None):
        rng = _ensure_rng(rng)
        for t in self.transforms:
            results = t(results, rng)
            if results is None:
                return None
        return results

    def __repr__(self):
        return "Compose(" + ", ".join(repr(t) for t in self.transforms) + ")"


class LoadImageFromFile:
    """PIL load -> RGB uint8 HWC + shape/meta fields
    (pipelines/loading.py:19-145).

    ``cache_mb > 0`` keeps decoded images in a process-wide FIFO cache
    (shared by thread workers; per-process in process mode). RepeatAug
    sampling revisits every image 3x per epoch and epochs revisit all of
    them, so decode (~4 ms per 640x480 JPEG, tools/profile_loader.py)
    amortizes to near zero once the working set fits. Returns a copy on
    hit so in-place transforms can never corrupt the cache."""

    _cache: dict = {}
    _cache_bytes = 0

    def __init__(self, cache_mb: int = 0, to_float32: bool = False):
        self.cache_budget = int(cache_mb) * (1 << 20)
        del to_float32  # config-parity arg; images convert at Normalize

    def __call__(self, results, rng=None):
        if "img" not in results:
            path = os.path.join(results.get("img_prefix", ""),
                                results["img_info"]["filename"])
            img = self._cache.get(path) if self.cache_budget else None
            if img is not None:
                img = img.copy()
            else:
                with Image.open(path) as im:
                    img = np.asarray(im.convert("RGB"))
                if self.cache_budget:
                    cls = LoadImageFromFile
                    while (cls._cache_bytes + img.nbytes > self.cache_budget
                           and cls._cache):
                        old = cls._cache.pop(next(iter(cls._cache)))
                        cls._cache_bytes -= old.nbytes
                    if img.nbytes <= self.cache_budget:
                        cls._cache[path] = img
                        cls._cache_bytes += img.nbytes
            results["filename"] = path
            results["ori_filename"] = results["img_info"]["filename"]
            results["img"] = img
        img = results["img"]
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results["img_fields"] = ["img"]
        return results


class Resize:
    """size int -> exact (size, size); (h, -1) -> adaptive short/long side
    (transforms.py:720-820)."""

    def __init__(self, size, interpolation="bilinear", adaptive_side="short",
                 backend="pillow"):
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.adaptive = size[1] == -1
        self.adaptive_side = adaptive_side
        self.interpolation = interpolation

    def _target(self, h, w):
        if not self.adaptive:
            return self.size
        s = self.size[0]
        short, long = (h, w) if h < w else (w, h)
        if self.adaptive_side == "short":
            scale = s / short
        elif self.adaptive_side == "long":
            scale = s / long
        elif self.adaptive_side == "height":
            scale = s / h
        else:
            scale = s / w
        return int(round(h * scale)), int(round(w * scale))

    def __call__(self, results, rng=None):
        img = results["img"]
        th, tw = self._target(*img.shape[:2])
        pil = Image.fromarray(img).resize((tw, th), PIL_INTERP[self.interpolation])
        results["img"] = np.asarray(pil)
        results["img_shape"] = results["img"].shape
        return results


class CenterCrop:
    def __init__(self, crop_size):
        self.crop_size = (crop_size, crop_size) if isinstance(crop_size, int) \
            else tuple(crop_size)

    def __call__(self, results, rng=None):
        img = results["img"]
        h, w = img.shape[:2]
        ch, cw = self.crop_size
        y1 = max((h - ch) // 2, 0)
        x1 = max((w - cw) // 2, 0)
        results["img"] = img[y1:y1 + ch, x1:x1 + cw]
        results["img_shape"] = results["img"].shape
        return results


def random_resized_crop_params(rng, h, w, scale, ratio):
    """torchvision RandomResizedCrop sampling: 10 tries, then center
    fallback."""
    area = h * w
    log_ratio = np.log(np.array(ratio))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = np.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y1 = int(rng.integers(0, h - ch + 1))
            x1 = int(rng.integers(0, w - cw + 1))
            return y1, x1, ch, cw
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        img = results["img"]
        y1, x1, ch, cw = random_resized_crop_params(
            rng, img.shape[0], img.shape[1], self.scale, self.ratio)
        pil = Image.fromarray(img[y1:y1 + ch, x1:x1 + cw])
        pil = pil.resize(self.size[::-1], PIL_INTERP[self.interpolation])
        results["img"] = np.asarray(pil)
        results["img_shape"] = results["img"].shape
        return results


class RandomFlip:
    def __init__(self, flip_prob=0.5, direction="horizontal"):
        self.flip_prob = flip_prob
        self.direction = direction

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.flip_prob:
            axis = 1 if self.direction == "horizontal" else 0
            results["img"] = np.flip(results["img"], axis=axis).copy()
            results["flip"] = True
        else:
            results["flip"] = False
        return results


class Normalize:
    """uint8 RGB -> float32 (x - mean) / std (transforms.py Normalize;
    ``to_rgb`` accepted for config parity — images are already RGB here).
    Uses the GIL-free native op (``gkgnet_tpu_torch.native``) so
    normalize doesn't serialize the threaded loader.

    ``device=True`` defers the arithmetic to the card: the image stays
    uint8 through collate and the host-to-device copy (4x fewer bytes)
    and the training/eval loop normalizes on the card
    (``gkgnet_tpu_torch.core.trainer.make_device_normalize``)."""

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD, to_rgb=True,
                 device=False):
        self.mean = np.array(mean, dtype=np.float32)
        self.std = np.array(std, dtype=np.float32)
        self.device = device

    def __call__(self, results, rng=None):
        img = results["img"]
        if self.device:
            results["img"] = np.ascontiguousarray(img)
        elif img.dtype == np.uint8:
            results["img"] = normalize_u8(np.ascontiguousarray(img),
                                          self.mean, self.std)
        else:
            results["img"] = (img.astype(np.float32) - self.mean) / self.std
        results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                       device=self.device)
        return results


class ColorJitter:
    """brightness/contrast/saturation jitter, torchvision semantics (random
    factor in [max(0, 1-v), 1+v], random order). Runs as a GIL-free float
    pass chain (native/fastops.cpp color_jitter; ITU-R 601 luma, clip
    after every op) — PIL's enhance round-tripped a uint8 Image per op and
    measured 22-29% of per-sample host cost. The upstream reference uses
    yet another implementation (cv2 LUTs), so exact PIL bit-parity was
    never the contract; determinism across hosts/worker modes is."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0):
        self.brightness, self.contrast, self.saturation = \
            brightness, contrast, saturation

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        ops = []
        if self.brightness > 0:
            ops.append((0, rng.uniform(max(0, 1 - self.brightness),
                                       1 + self.brightness)))
        if self.contrast > 0:
            ops.append((1, rng.uniform(max(0, 1 - self.contrast),
                                       1 + self.contrast)))
        if self.saturation > 0:
            ops.append((2, rng.uniform(max(0, 1 - self.saturation),
                                       1 + self.saturation)))
        order = rng.permutation(len(ops))
        results["img"] = color_jitter(
            np.ascontiguousarray(results["img"]), [ops[i] for i in order])
        return results


class RandomErasing:
    """transforms.py:528-654 exactly (log-uniform aspect, const/rand fill)."""

    def __init__(self, erase_prob=0.5, min_area_ratio=0.02, max_area_ratio=0.4,
                 aspect_range=(3 / 10, 10 / 3), mode="const",
                 fill_color=(128, 128, 128), fill_std=None):
        if isinstance(aspect_range, float):
            a = min(aspect_range, 1 / aspect_range)
            aspect_range = (a, 1 / a)
        self.erase_prob = erase_prob
        self.min_area_ratio = min_area_ratio
        self.max_area_ratio = max_area_ratio
        self.aspect_range = aspect_range
        self.mode = mode
        if not isinstance(fill_color, (list, tuple)):
            fill_color = [fill_color] * 3
        self.fill_color = list(fill_color)
        if fill_std is not None and not isinstance(fill_std, (list, tuple)):
            fill_std = [fill_std] * 3
        self.fill_std = list(fill_std) if fill_std is not None else None

    def _fill(self, rng, h, w):
        if self.mode == "const":
            patch = np.empty((h, w, 3), dtype=np.uint8)
            patch[:, :] = np.array(self.fill_color, dtype=np.uint8)
        elif self.fill_std is None:
            patch = rng.uniform(0, 256, (h, w, 3)).astype(np.uint8)
        else:
            patch = rng.normal(self.fill_color, self.fill_std, (h, w, 3))
            patch = np.clip(patch.astype(np.int32), 0, 255).astype(np.uint8)
        return patch

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() > self.erase_prob:
            return results
        img = results["img"].copy()
        img_h, img_w = img.shape[:2]
        log_ar = np.log(np.array(self.aspect_range, dtype=np.float32))
        aspect = np.exp(rng.uniform(*log_ar))
        area = img_h * img_w * rng.uniform(self.min_area_ratio, self.max_area_ratio)
        h = min(int(round(np.sqrt(area * aspect))), img_h)
        w = min(int(round(np.sqrt(area / aspect))), img_w)
        top = int(rng.integers(0, img_h - h)) if img_h > h else 0
        left = int(rng.integers(0, img_w - w)) if img_w > w else 0
        img[top:top + h, left:left + w] = self._fill(rng, h, w)
        results["img"] = img
        return results


class Trivial:
    """TrivialAugment wrapper (transforms.py:21-33)."""

    def __init__(self, p=1.0):
        self.p = p
        self.aug = TrivialAugment()

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(self.aug(img, rng))
        return results


class RandAug:
    """RandAugment wrapper (n ops at magnitude m over the shared op
    library; reference aug_lib.py:625-636 / auto_augment.py RandAugment)."""

    def __init__(self, n=2, m=10, p=1.0):
        self.p = p
        self.aug = RandAugment(n, m)

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(self.aug(img, rng))
        return results


class AutoAug:
    """AutoAugment wrapper (ImageNet policy by default; reference
    datasets/pipelines/auto_augment.py:47-116)."""

    def __init__(self, policies=None, p=1.0):
        self.p = p
        self.aug = AutoAugment(policies)

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(self.aug(img, rng))
        return results


class UniAug:
    """UniAugment wrapper: 2 random ops each applied with prob 0.5 at a
    random level (aug_lib.py:638-644)."""

    def __init__(self, p=1.0):
        self.p = p
        self.aug = UniAugment()

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(self.aug(img, rng))
        return results


class UniAugWeighted:
    """UniAugmentWeighted wrapper: op count drawn from ``probs``
    (aug_lib.py:646-657)."""

    def __init__(self, probs=(0.2, 0.3, 0.5), p=1.0):
        self.p = p
        self.aug = UniAugmentWeighted(probs)

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(self.aug(img, rng))
        return results


class Cutout:
    """Standalone Cutout step (aug_lib.py:305-333): zero a square patch,
    side = level/30 x (max_frac x width)."""

    def __init__(self, level=15, max_frac=0.2, p=0.5):
        self.level = level
        self.max_frac = max_frac
        self.p = p

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.p:
            img = Image.fromarray(results["img"])
            results["img"] = np.asarray(
                _cutout(img, self.level, rng, self.max_frac))
        return results


class CropMixup:
    """CropMix multi-scale crop mixing (pipelines/cropmix.py + the
    transforms.py:36-71 wrapper).

    With prob p: sample number of views n in {2,3,4} (if number==234), take
    n RandomResizedCrops at staged scale bands (the last at (0.99, 1)),
    shuffle, and fold them together with beta-mixup (operation=0) or cutmix
    (operation=1), optionally channel-permuting one side ("inter_aug").
    Otherwise: plain bicubic resize to the target size.
    """

    def __init__(self, p=0.5, size=224, scale=0.08, mix_ratio=0.4, number=234,
                 operation=0, inter_aug=1):
        self.p = p
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.mix_ratio = mix_ratio
        self.number = number
        self.operation = operation
        self.inter_aug = inter_aug

    def _views(self, img, n, rng):
        views = []
        s, n_f = self.scale, float(n)
        for i in range(n - 1):
            lo = s + i * (1 - s) / n_f
            hi = s + (i + 1) * (1 - s) / n_f
            views.append(self._rrc(img, (lo, hi) if n > 2 else (s, 1.0), rng))
        views.append(self._rrc(img, (0.99, 1.0), rng))
        return views

    def _rrc(self, img, scale, rng):
        y1, x1, ch, cw = random_resized_crop_params(
            rng, img.shape[0], img.shape[1], scale, (3 / 4, 4 / 3))
        pil = Image.fromarray(img[y1:y1 + ch, x1:x1 + cw])
        pil = pil.resize(self.size[::-1], Image.BILINEAR)
        # views stay uint8: the blend chain runs 255-scale in native code
        # (native/fastops.cpp mix_chain), which skips a float32 /255
        # conversion per view + 2-3 numpy temporaries per blend pass —
        # measured 54% of per-sample host cost (tools/profile_loader.py)
        return np.asarray(pil)

    def _mixup(self, v1, v2, lam, rng):
        if self.inter_aug:
            perm = rng.permutation(3)
            if lam > 0.5:
                return lam * v1 + (1 - lam) * v2[..., perm]
            return lam * v1[..., perm] + (1 - lam) * v2
        return lam * v1 + (1 - lam) * v2

    def _cutmix(self, v1, v2, rng):
        lam = rng.uniform(0.0, 1.0)
        lam2 = rng.uniform(0.0, 1.0)
        h, w = v1.shape[:2]
        cut = np.sqrt(1.0 - lam)
        cw, ch = int(w * cut), int(h * cut)
        cx, cy = int(rng.integers(w)), int(rng.integers(h))
        x1, y1 = np.clip(cx - cw // 2, 0, w), np.clip(cy - ch // 2, 0, h)
        x2, y2 = np.clip(cx + cw // 2, 0, w), np.clip(cy + ch // 2, 0, h)
        v1, v2 = v1.copy(), v2.copy()
        if self.inter_aug:
            perm = rng.permutation(3)
            if lam2 > 0.5:
                v1[y1:y2, x1:x2] = v2[y1:y2, x1:x2][..., perm]
                return v1
            v1 = v1[..., perm]
            v2[y1:y2, x1:x2] = v1[y1:y2, x1:x2]
            return v2
        if lam2 > 0.5:
            v1[y1:y2, x1:x2] = v2[y1:y2, x1:x2]
            return v1
        v2[y1:y2, x1:x2] = v1[y1:y2, x1:x2]
        return v2

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        img = results["img"]
        if rng.random() < self.p:
            n = self.number
            if n == 234:
                n = int(rng.choice([2, 3, 4]))
            views = self._views(img, n, rng)
            order = rng.permutation(n)
            if self.operation == 0:
                # same rng draw order as the per-pass loop: beta, then the
                # channel permutation (when inter_aug)
                plan = []
                for _ in order[1:]:
                    lam = float(rng.beta(self.mix_ratio / n,
                                         self.mix_ratio / n))
                    if self.inter_aug:
                        perm = rng.permutation(3)
                        side = 1 if lam > 0.5 else 2
                    else:
                        perm = (0, 1, 2)
                        side = 0
                    plan.append((lam, side, *(int(p) for p in perm)))
                results["img"] = mix_chain([views[i] for i in order], plan)
            else:
                mixed = views[order[0]]
                for i in order[1:]:
                    mixed = self._cutmix(mixed, views[i], rng)
                results["img"] = np.ascontiguousarray(mixed)
        else:
            pil = Image.fromarray(img).resize(self.size[::-1], Image.BICUBIC)
            results["img"] = np.asarray(pil)
        results["img_shape"] = results["img"].shape
        return results


class Pad:
    def __init__(self, size=None, pad_to_square=False, pad_val=0):
        self.size = size
        self.pad_to_square = pad_to_square
        self.pad_val = pad_val

    def __call__(self, results, rng=None):
        img = results["img"]
        h, w = img.shape[:2]
        if self.pad_to_square:
            th = tw = max(h, w)
        else:
            th, tw = self.size
        out = np.full((th, tw) + img.shape[2:], self.pad_val, dtype=img.dtype)
        out[:h, :w] = img
        results["img"] = out
        results["img_shape"] = out.shape
        return results


class Lighting:
    """AlexNet-style PCA color noise (transforms.py Lighting)."""

    def __init__(self, eigval, eigvec, alphastd=0.1, to_rgb=True):
        self.eigval = np.array(eigval, dtype=np.float32)
        self.eigvec = np.array(eigvec, dtype=np.float32)
        self.alphastd = alphastd

    def __call__(self, results, rng=None):
        rng = _ensure_rng(rng)
        img = results["img"].astype(np.float32)
        alpha = rng.normal(0, self.alphastd, 3).astype(np.float32)
        results["img"] = img + self.eigvec @ (alpha * self.eigval)
        return results


class Collect:
    """Keep only the final keys (formatting.py Collect)."""

    def __init__(self, keys=("img", "gt_label")):
        self.keys = keys

    def __call__(self, results, rng=None):
        return {k: results[k] for k in self.keys if k in results}


def build_train_pipeline(crop_size=576, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The live GKGNet COCO train pipeline (cfg:45-65)."""
    return Compose([
        LoadImageFromFile(),
        CropMixup(p=0.5, size=crop_size, scale=0.01, number=234),
        RandomFlip(flip_prob=0.5, direction="horizontal"),
        RandomErasing(erase_prob=0.5, mode="rand", min_area_ratio=0.02,
                      max_area_ratio=1 / 3, fill_color=mean, fill_std=std),
        ColorJitter(brightness=0.4, contrast=0.4, saturation=0.4),
        Trivial(p=1.0),
        Normalize(mean, std),
        Collect(("img", "gt_label")),
    ])


def build_test_pipeline(crop_size=576, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """The live test pipeline (cfg:67-79): bicubic resize + normalize."""
    return Compose([
        LoadImageFromFile(),
        Resize(crop_size, interpolation="bicubic", backend="pillow"),
        Normalize(mean, std),
        Collect(("img",)),
    ])


TRANSFORMS = {
    "LoadImageFromFile": LoadImageFromFile,
    "Resize": Resize,
    "CenterCrop": CenterCrop,
    "RandomResizedCrop": RandomResizedCrop,
    "RandomFlip": RandomFlip,
    "Normalize": Normalize,
    "ColorJitter": ColorJitter,
    "RandomErasing": RandomErasing,
    "Trivial": Trivial,
    "RandAug": RandAug,
    "AutoAug": AutoAug,
    "UniAug": UniAug,
    "UniAugWeighted": UniAugWeighted,
    "Cutout": Cutout,
    "CropMixup": CropMixup,
    "Pad": Pad,
    "Lighting": Lighting,
    "Collect": Collect,
}


def build_pipeline(cfgs: list[dict]) -> Compose:
    """Config-driven pipeline builder (mmcv-style ``type`` keys; tensor
    formatting steps of the reference are layout no-ops here and skipped)."""
    skip = {"ImageToTensor", "ToTensor"}
    steps = []
    for cfg in cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t in skip:
            continue
        steps.append(TRANSFORMS[t](**cfg))
    return Compose(steps)
