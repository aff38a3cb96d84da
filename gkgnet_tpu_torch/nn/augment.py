"""Batch-level augmentations: mixup and cutmix, built from a config's
``model.train_cfg.augments`` (counterpart: ``gkgnet_tpu/nn/augment.py``;
the reference's ``models/utils/augment``).

They act on device batches inside the train step: NHWC images and
``(B, C)`` soft or multi-hot labels. The random draws come from an explicit
``torch.Generator`` on the batch's device; ``mixup_with`` and
``cutmix_with`` take the drawn values themselves (the mixing weight, the
partner permutation and the box centre), so that a test can give both
packages the same draws.
"""

from __future__ import annotations

from typing import Callable

import torch


def sample_beta(alpha: float, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """One fp32 draw of Beta(alpha, alpha): X / (X + Y) of two
    Gamma(alpha) draws."""
    xy = torch._standard_gamma(
        torch.full((2,), float(alpha), device=device), generator=generator)
    return xy[0] / (xy[0] + xy[1])


def mixup_with(imgs: torch.Tensor, labels: torch.Tensor, lam: torch.Tensor,
               perm: torch.Tensor):
    """``lam * a + (1 - lam) * a[perm]`` of the images and the labels."""
    lam = lam.to(torch.float32)
    mixed = lam * imgs + (1.0 - lam) * imgs[perm]
    mixed_labels = lam * labels + (1.0 - lam) * labels[perm]
    return mixed, mixed_labels


def cutmix_with(imgs: torch.Tensor, labels: torch.Tensor, lam: torch.Tensor,
                perm: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor):
    """Paste the box of side ``int(side * sqrt(1 - lam))`` centred at
    (cy, cx), clipped to the image, from each sample's partner; the labels
    mix by the box's share of the area. No value leaves the device."""
    b, h, w, _ = imgs.shape
    cut_rat = torch.sqrt(1.0 - lam.to(torch.float32))
    cut_h = (h * cut_rat).to(torch.int32)
    cut_w = (w * cut_rat).to(torch.int32)
    y1 = torch.clamp(cy - cut_h // 2, 0, h)
    y2 = torch.clamp(cy + cut_h // 2, 0, h)
    x1 = torch.clamp(cx - cut_w // 2, 0, w)
    x2 = torch.clamp(cx + cut_w // 2, 0, w)
    rows = torch.arange(h, device=imgs.device)[None, :, None, None]
    cols = torch.arange(w, device=imgs.device)[None, None, :, None]
    box = (rows >= y1) & (rows < y2) & (cols >= x1) & (cols < x2)
    mixed = torch.where(box, imgs[perm], imgs)
    area = ((y2 - y1) * (x2 - x1)).to(torch.float32) / float(h * w)
    lam_adj = 1.0 - area
    mixed_labels = lam_adj * labels + (1.0 - lam_adj) * labels[perm]
    return mixed, mixed_labels


def batch_mixup(imgs: torch.Tensor, labels: torch.Tensor, alpha: float,
                generator: torch.Generator):
    """Mixup: lam ~ Beta(alpha, alpha), a random partner per sample."""
    lam = sample_beta(alpha, generator, imgs.device)
    perm = torch.randperm(imgs.shape[0], generator=generator,
                          device=imgs.device)
    return mixup_with(imgs, labels, lam, perm)


def batch_cutmix(imgs: torch.Tensor, labels: torch.Tensor, alpha: float,
                 generator: torch.Generator):
    """CutMix: lam ~ Beta(alpha, alpha), a random partner per sample and a
    box centre uniform over the image."""
    _, h, w, _ = imgs.shape
    lam = sample_beta(alpha, generator, imgs.device)
    perm = torch.randperm(imgs.shape[0], generator=generator,
                          device=imgs.device)
    cy = torch.randint(0, h, (), generator=generator, device=imgs.device)
    cx = torch.randint(0, w, (), generator=generator, device=imgs.device)
    return cutmix_with(imgs, labels, lam, perm, cy, cx)


def build_batch_augment(cfgs: list[dict] | None) -> Callable | None:
    """``train_cfg.augments``: a list of ``{type, alpha, prob}`` (types
    containing 'mixup' or 'cutmix'), or None. Returns
    ``apply(imgs, labels, generator) -> (imgs, labels)``, which draws one
    of them per call by the normalized probabilities (each ``1 / len``
    by default; ``apply.pick(generator)`` draws the choice, then
    ``apply.fns[choice]`` runs), or None without augments."""
    if not cfgs:
        return None
    fns, probs = [], []
    for cfg in cfgs:
        t = cfg["type"].lower()
        alpha = cfg.get("alpha", 1.0)
        if "mixup" in t:
            fns.append(lambda i, lab, g, a=alpha: batch_mixup(i, lab, a, g))
        elif "cutmix" in t:
            fns.append(lambda i, lab, g, a=alpha: batch_cutmix(i, lab, a, g))
        else:
            raise ValueError(f"unknown batch augment {t}")
        probs.append(cfg.get("prob", 1.0 / len(cfgs)))
    weights = torch.tensor(probs, dtype=torch.float32) / sum(probs)

    def pick(generator: torch.Generator) -> int:
        """Draw which augment runs. With several, the draw is read back
        on the host (a compiled train step keeps a graph for each); with
        one, nothing is read."""
        drawn = torch.multinomial(weights.to(generator.device), 1,
                                  generator=generator)
        return 0 if len(fns) == 1 else int(drawn)

    def apply(imgs: torch.Tensor, labels: torch.Tensor,
              generator: torch.Generator):
        return fns[pick(generator)](imgs, labels, generator)

    apply.fns, apply.weights, apply.pick = fns, weights, pick
    return apply
