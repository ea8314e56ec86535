"""Host-side image I/O (the JAX package's ``utils/io.py``).

Pixels come back as float32 arrays in [0, 255], (H, W, C) with C in
{1, 3}, alpha dropped like the reference (src/image_io.cpp:27).  Decoding
goes through the native libjpeg / libpng decoder when it builds
(``utils/native``), else through Pillow; codecs are a host concern.
"""

from __future__ import annotations

import numpy as np
from PIL import Image as PILImage

from sift_tpu_torch.utils import native


def load_image(path: str, dtype=np.float32) -> np.ndarray:
    """Load an image file as an (H, W, C) float array in [0, 255]."""
    if dtype == np.float32 and native.available():
        arr = native.decode_image(path)
        if arr is not None:
            return arr[:, :, :3]
    with PILImage.open(path) as im:
        if im.mode in ("RGBA", "P", "CMYK", "LA"):
            im = im.convert("RGB")
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr[:, :, :3].astype(dtype)


def save_image(path: str, arr: np.ndarray) -> None:
    """Save an (H, W) or (H, W, C) float array in [0, 255], clamped like
    src/image_io.cpp:103-104."""
    a = np.clip(np.asarray(arr), 0, 255).astype(np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    PILImage.fromarray(a).save(path)
