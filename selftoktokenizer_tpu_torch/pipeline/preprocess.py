"""Image preprocessing of the reference's test transform stack: shortest
side resized to ``size`` (bilinear, the long side truncated as torchvision's
``Resize`` does), centre crop (torchvision's rounding of the offset), then
``x / 127.5 - 1``. Non-RGB inputs (grayscale, RGBA, palette) are converted
to RGB first, as the C++ loader (``csrc/dataloader.cc``) converts them.

PIL and numpy only, imported inside the functions that need PIL, so the
package imports without it. The port's own copy of the reference package's
``pipeline/preprocess.py``, bit for bit the same results.
"""

from __future__ import annotations

import numpy as np


def load_image(path, size):
    """An image file -> float32 NHWC [1, size, size, 3] in [-1, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return preprocess_pil(img, size)


def preprocess_pil(img, size):
    """PIL image -> float32 NHWC [1, size, size, 3] in [-1, 1]."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    # torchvision Resize(size): shortest side -> size, the long side
    # int(size * long / short), bilinear
    if w < h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    img = img.resize((nw, nh), resample=2)  # PIL.Image.BILINEAR
    # torchvision CenterCrop: int(round((dim - size) / 2))
    left = int(round((nw - size) / 2.0))
    top = int(round((nh - size) / 2.0))
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img).astype(np.float32)
    arr = arr / 127.5 - 1.0
    return arr[None, ...]


def to_uint8(images01):
    """[0, 1] float NHWC (numpy or tensor) -> uint8, rounded to nearest."""
    if hasattr(images01, "detach"):
        images01 = images01.detach().float().cpu().numpy()
    return np.clip(np.asarray(images01) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_image(images01, path):
    """The first image of a [0, 1] NHWC batch (or one HWC image) -> a file
    whose format PIL takes from the name."""
    from PIL import Image

    arr = to_uint8(images01)
    if arr.ndim == 4:
        arr = arr[0]
    Image.fromarray(arr).save(path)
