"""TrivialAugment (fixed_standard space) — counterpart:
``gkgnet_tpu/data/trivial_augment.py``, a copy; reference
datasets/pipelines/aug_lib.py:346-624.

One op sampled uniformly from the 14-op standard list, one strength level
sampled uniformly in [0, 30]; 'fixed_standard' ranges: posterize bits in
[4, 8], shear max 0.3, translate max 10 px, rotate max 30 deg,
solarize max 256, enhancers in [0.1, 1.9].

All randomness comes from an explicit ``np.random.Generator`` so the host
pipeline is reproducible (multi-host determinism, SURVEY hard part #4).
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw, ImageEnhance, ImageOps

PARAMETER_MAX = 30

SHEAR_MAX = 0.3
TRANSLATE_MAX = 10
ROTATE_MAX = 30
SOLARIZE_MAX = 256
POSTERIZE_MIN, POSTERIZE_MAX = 4, 8
ENHANCER_MIN, ENHANCER_MAX = 0.1, 1.9


def _float_param(level, maxval):
    return float(level) * maxval / PARAMETER_MAX


def _int_param(level, maxval):
    return int(level * maxval / PARAMETER_MAX)


def _signed(value, rng):
    return -value if rng.random() > 0.5 else value


def _identity(img, level, rng):
    return img


def _auto_contrast(img, level, rng):
    return ImageOps.autocontrast(img)


def _equalize(img, level, rng):
    return ImageOps.equalize(img)


def _rotate(img, level, rng):
    return img.rotate(_signed(_int_param(level, ROTATE_MAX), rng))


def _solarize(img, level, rng):
    return ImageOps.solarize(img, 256 - _int_param(level, SOLARIZE_MAX))


def _posterize(img, level, rng):
    level = _int_param(level, POSTERIZE_MAX - POSTERIZE_MIN)
    return ImageOps.posterize(img, POSTERIZE_MAX - level)


def _enhancer(enhancer_cls):
    def op(img, level, rng):
        v = _float_param(level, ENHANCER_MAX - ENHANCER_MIN) + ENHANCER_MIN
        return enhancer_cls(img).enhance(v)

    return op


def _shear_x(img, level, rng):
    v = _signed(_float_param(level, SHEAR_MAX), rng)
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, level, rng):
    v = _signed(_float_param(level, SHEAR_MAX), rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, level, rng):
    v = _signed(_int_param(level, TRANSLATE_MAX), rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y(img, level, rng):
    v = _signed(_int_param(level, TRANSLATE_MAX), rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


STANDARD_OPS = [
    ("identity", _identity),
    ("auto_contrast", _auto_contrast),
    ("equalize", _equalize),
    ("rotate", _rotate),
    ("solarize", _solarize),
    ("color", _enhancer(ImageEnhance.Color)),
    ("posterize", _posterize),
    ("contrast", _enhancer(ImageEnhance.Contrast)),
    ("brightness", _enhancer(ImageEnhance.Brightness)),
    ("sharpness", _enhancer(ImageEnhance.Sharpness)),
    ("shear_x", _shear_x),
    ("shear_y", _shear_y),
    ("translate_x", _translate_x),
    ("translate_y", _translate_y),
]


class TrivialAugment:
    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        _, op = STANDARD_OPS[rng.integers(len(STANDARD_OPS))]
        level = int(rng.integers(0, PARAMETER_MAX + 1))
        return op(img, level, rng)


class RandAugment:
    """n ops at fixed magnitude m (aug_lib.py:625-636)."""

    def __init__(self, n: int, m: int):
        self.n, self.m = n, m

    def __call__(self, img, rng):
        for _ in range(self.n):
            _, op = STANDARD_OPS[rng.integers(len(STANDARD_OPS))]
            img = op(img, self.m, rng)
        return img


def _invert(img, level, rng):
    return ImageOps.invert(img)


def _crop_bilinear(img, level, rng):
    """Crop a level-dependent border then resize back (aug_lib.py:215-226
    CropBilinear)."""
    lv = _int_param(level, 10)
    w, h = img.size
    return img.crop((lv, lv, w - lv, h - lv)).resize((w, h), Image.BILINEAR)


def _cutout(img, level, rng, max_frac: float = 0.2):
    """Zero a square patch whose size scales with level
    (aug_lib.py:305-333 Cutout/CutoutDefault; the random center matches
    np.random.uniform(w/h) semantics with the explicit generator)."""
    v = _int_param(level, int(img.size[0] * max_frac))
    if v <= 0:
        return img
    w, h = img.size
    x0 = int(max(0, rng.uniform(0, w) - v / 2.0))
    y0 = int(max(0, rng.uniform(0, h) - v / 2.0))
    img = img.copy()
    ImageDraw.Draw(img).rectangle((x0, y0, min(w, x0 + v), min(h, y0 + v)),
                                  (0, 0, 0))
    return img


class SamplePairing:
    """Blend with a random image from a provided pool
    (aug_lib.py:336-345 'SamplePairing'; the reference's module-global
    ``blend_images`` becomes an explicit constructor argument)."""

    def __init__(self, images):
        assert images, "SamplePairing needs a non-empty image pool"
        self.images = images

    def __call__(self, img, level, rng):
        other = self.images[rng.integers(len(self.images))]
        if other.size != img.size:
            other = other.resize(img.size, Image.BILINEAR)
        return Image.blend(img, other.convert(img.mode),
                           _float_param(level, 0.4))


OPS_BY_NAME = dict(STANDARD_OPS)
OPS_BY_NAME["invert"] = _invert
OPS_BY_NAME["crop_bilinear"] = _crop_bilinear
OPS_BY_NAME["cutout"] = _cutout


class UniAugment:
    """Two random ops, each applied with probability 0.5 at a random level
    (aug_lib.py:638-644)."""

    def __call__(self, img, rng):
        for _ in range(2):
            _, op = STANDARD_OPS[rng.integers(len(STANDARD_OPS))]
            if rng.random() < 0.5:
                img = op(img, int(rng.integers(0, PARAMETER_MAX + 1)), rng)
        return img


class UniAugmentWeighted:
    """Draw the op COUNT from a categorical (probs[k] = P(k ops)), then
    apply that many random ops at random levels (aug_lib.py:646-657)."""

    def __init__(self, probs=(0.2, 0.3, 0.5)):
        self.probs = np.asarray(probs, np.float64) / np.sum(probs)

    def __call__(self, img, rng):
        k = int(rng.choice(len(self.probs), p=self.probs))
        for _ in range(k):
            _, op = STANDARD_OPS[rng.integers(len(STANDARD_OPS))]
            img = op(img, int(rng.integers(0, PARAMETER_MAX + 1)), rng)
        return img
OPS_BY_NAME["invert"] = _invert

# AutoAugment ImageNet policy (reference datasets/pipelines/auto_augment.py:
# 47-116 — registered, unused by the GKGNet config). Each sub-policy is two
# (op, prob, magnitude 0-9) steps; magnitudes map onto the 0-30 level scale
# of the fixed_standard op space above.
IMAGENET_POLICY = [
    [("posterize", 0.4, 8), ("rotate", 0.6, 9)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, 5)],
    [("equalize", 0.8, 8), ("equalize", 0.6, 3)],
    [("posterize", 0.6, 7), ("posterize", 0.6, 6)],
    [("equalize", 0.4, 7), ("solarize", 0.2, 4)],
    [("equalize", 0.4, 4), ("rotate", 0.8, 8)],
    [("solarize", 0.6, 3), ("equalize", 0.6, 7)],
    [("posterize", 0.8, 5), ("equalize", 1.0, 2)],
    [("rotate", 0.2, 3), ("solarize", 0.6, 8)],
    [("equalize", 0.6, 8), ("posterize", 0.4, 6)],
    [("rotate", 0.8, 8), ("color", 0.4, 0)],
    [("rotate", 0.4, 9), ("equalize", 0.6, 2)],
    [("equalize", 0.0, 7), ("equalize", 0.8, 8)],
    [("invert", 0.6, 4), ("equalize", 1.0, 8)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("rotate", 0.8, 8), ("color", 1.0, 2)],
    [("color", 0.8, 8), ("solarize", 0.8, 7)],
    [("sharpness", 0.4, 7), ("invert", 0.6, 8)],
    [("shear_x", 0.6, 5), ("equalize", 1.0, 9)],
    [("color", 0.4, 0), ("equalize", 0.6, 3)],
    [("equalize", 0.4, 7), ("solarize", 0.2, 4)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, 5)],
    [("invert", 0.6, 4), ("equalize", 1.0, 8)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("equalize", 0.8, 8), ("equalize", 0.6, 3)],
]


class AutoAugment:
    """Policy-based AutoAugment: pick one sub-policy per call, apply each
    step with its probability at its magnitude."""

    def __init__(self, policies=None):
        self.policies = policies if policies is not None else IMAGENET_POLICY
        for policy in self.policies:
            for name, _, _ in policy:
                assert name in OPS_BY_NAME, name

    def __call__(self, img, rng):
        policy = self.policies[rng.integers(len(self.policies))]
        for name, prob, mag in policy:
            if rng.random() < prob:
                level = int(round(mag * PARAMETER_MAX / 9))
                img = OPS_BY_NAME[name](img, level, rng)
        return img
