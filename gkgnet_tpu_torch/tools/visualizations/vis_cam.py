"""Class activation and saliency (counterpart:
``tools/visualizations/vis_cam.py``): overlays (a) the channel mean of the
stage-4 activation and (b) the input-gradient saliency of the target class
onto the image.

    python -m gkgnet_tpu_torch.tools.visualizations.vis_cam IMG CONFIG \\
        [CKPT_DIR] [--target-class 14] [--out cam.png] [--device cpu]

One eval-mode forward with the gradient on (BatchNorm on its running
statistics): a forward hook on the last FFN takes the stage-4 output (the
JAX tool's ``capture_intermediates`` of ``backbone_14_ffn``), and
``torch.autograd.grad`` of the class's logit gives the gradient with
respect to the normalized image. On the card that forward and backward
launch the knn_mr forward and backward kernels once per graph conv. Runs on
the card unless ``--device cpu`` is given; raises without a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from gkgnet_tpu_torch.tools.inference import image_batch, init_model


def cam_and_saliency(model, imgs: torch.Tensor,
                     target_class: int | None = None
                     ) -> tuple[int, np.ndarray, np.ndarray]:
    """``(class, cam, saliency)`` for a normalized (1, H, W, 3) batch: the
    class (the top logit unless given), the stage-4 channel mean of the
    rectified activation (h, w) and the channel max of |d logit / d image|
    (H, W), each scaled to a maximum of 1."""
    feats = []
    hook = model.backbone.backbone[-1][1].register_forward_hook(
        lambda module, args, out: feats.append(out))
    imgs = imgs.detach().requires_grad_(True)
    try:
        with torch.enable_grad():
            score, _ = model.eval()(imgs)
            cls = int(score[0].argmax() if target_class is None
                      else target_class)
            (grad,) = torch.autograd.grad(score[0, cls], imgs)
    finally:
        hook.remove()
    saliency = grad.abs()[0].amax(-1).float().cpu().numpy()
    saliency = saliency / (saliency.max() + 1e-8)
    cam = np.maximum(feats[0].detach()[0].float().cpu().numpy(), 0).mean(-1)
    cam = cam / (cam.max() + 1e-8)
    return cls, cam, saliency


def overlay(img_path: str, size: int, cam: np.ndarray,
            saliency: np.ndarray) -> np.ndarray:
    """The image at ``size`` with half the upsampled activation map and
    half the saliency added to its red channel: (size, size, 3) uint8."""
    cam_up = np.asarray(
        Image.fromarray(np.uint8(cam * 255)).resize((size, size),
                                                    Image.BILINEAR),
        np.float32) / 255.0
    heat = 0.5 * cam_up + 0.5 * saliency
    with Image.open(img_path) as im:
        base = np.asarray(im.convert("RGB").resize((size, size)), np.float32)
    out = base.copy()
    out[..., 0] = np.clip(base[..., 0] + 255 * heat, 0, 255)
    return np.uint8(out)


def main(argv=None) -> dict:
    """Returns ``{'class', 'cam', 'saliency', 'image', 'out'}``."""
    p = argparse.ArgumentParser(description="Activation and saliency map")
    p.add_argument("img")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--target-class", type=int, default=None,
                   help="class id (default: top prediction)")
    p.add_argument("--out", default="cam.png")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    model, cfg = init_model(args.config, args.checkpoint, args.device)
    cls, cam, saliency = cam_and_saliency(
        model, image_batch(model, cfg, args.img), args.target_class)
    image = overlay(args.img, cfg.model["size"], cam, saliency)
    Image.fromarray(image).save(args.out)
    print(f"saved activation/saliency map for class {cls} -> {args.out}")
    return {"class": cls, "cam": cam, "saliency": saliency, "image": image,
            "out": args.out}


if __name__ == "__main__":
    main()
