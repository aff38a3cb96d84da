"""Annotated-image output: draw prediction or info text onto an image
(counterpart: ``gkgnet_tpu/utils/visualization.py``, the reference's
``imshow_infos``).

PIL-based and headless: the annotated array comes back and can be written
to disk; matplotlib is imported only for ``show=True``.

    img = imshow_infos('cat.jpg', {'cat': 0.98, 'pred_class': 'cat'},
                       out_file='out.png')
"""

from __future__ import annotations

import numpy as np

# looked up by name in the system's font directories (Pillow's search);
# PIL's bitmap font where it is missing
FONT = "DejaVuSans.ttf"


def _load_image(img) -> np.ndarray:
    """str path | ndarray (H, W, 3) uint8/float -> RGB uint8 array."""
    if isinstance(img, str):
        from PIL import Image

        with Image.open(img) as im:
            return np.asarray(im.convert("RGB"))
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[..., :3]


def imshow_infos(
    img,
    infos: dict,
    text_color=(255, 255, 255),
    font_size: int = 26,
    row_width: int = 20,
    win_name: str = "",
    show: bool = False,
    wait_time: float = 0,
    out_file: str | None = None,
) -> np.ndarray:
    """Draw an info dict onto an image.

    Args:
      img: path or (H, W, 3) array.
      infos: ``{label: value}``; float values are rendered as ``.2f``.
      text_color: RGB tuple or color name for the text.
      font_size: text size in pixels (TrueType when available, else the
        PIL bitmap font).
      row_width: vertical spacing between rows.
      show: pop an interactive window (matplotlib); off by default.
      out_file: write the annotated image here when given.

    Returns:
      (H, W, 3) uint8 annotated image.
    """
    from PIL import Image, ImageDraw, ImageFont

    arr = _load_image(img)
    im = Image.fromarray(arr)
    draw = ImageDraw.Draw(im, "RGBA")
    try:
        font = ImageFont.truetype(FONT, font_size)
    except OSError:
        font = ImageFont.load_default()

    x, y = 3, max(row_width // 2, 2)
    step = max(row_width, font_size + 4)
    for k, v in infos.items():
        if isinstance(v, float):
            v = f"{v:.2f}"
        label_text = f"{k}: {v}"
        # a dark backing bar keeps white text readable on any image
        bbox = draw.textbbox((x, y), label_text, font=font)
        draw.rectangle([bbox[0] - 2, bbox[1] - 1, bbox[2] + 2, bbox[3] + 1],
                       fill=(0, 0, 0, 160))
        draw.text((x, y), label_text, fill=text_color, font=font)
        y += step

    out = np.asarray(im)
    if out_file is not None:
        im.save(out_file)
    if show:  # pragma: no cover - interactive path
        import matplotlib.pyplot as plt

        plt.figure(win_name or "imshow_infos")
        plt.imshow(out)
        plt.axis("off")
        plt.show(block=wait_time == 0)
        if wait_time:
            plt.pause(wait_time)
    return out


def imshow_predictions(img, preds, out_file: str | None = None,
                       **kwargs) -> np.ndarray:
    """Classifier predictions onto an image: ``preds`` is a list of
    ``{'class_name', 'score'}`` dicts (``tools.inference``'s output)."""
    infos = {p["class_name"]: float(p["score"]) for p in preds}
    return imshow_infos(img, infos, out_file=out_file, **kwargs)
