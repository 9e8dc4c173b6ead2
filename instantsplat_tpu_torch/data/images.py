"""Image loading and saving (port of the parts of
instantsplat_tpu/data/images.py that stages 2-5 use).

PNG goes through the package's own codec (data/png.py), so PNG scenes need
no Pillow. Other formats (JPEG, ...) and resizing use Pillow when it is
installed and raise a clear error when it is not.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import png


def _pillow(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs Pillow, which is not installed; store the scene's "
            "images as 8-bit PNG (read without Pillow) at the resolution "
            "recorded in cameras.txt") from e
    return Image


def _to_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 3], as PIL's convert("RGB") does: grey is
    replicated, alpha is dropped (not composited)."""
    if arr.shape[2] in (1, 2):
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return arr[:, :, :3]


def load_image(path) -> np.ndarray:
    """-> [H, W, 3] float32 in [0, 1]."""
    if Path(path).suffix.lower() == ".png":
        arr = _to_rgb(png.read_png(path))
    else:
        Image = _pillow(f"reading {path}")
        arr = np.asarray(Image.open(path).convert("RGB"))
    return arr.astype(np.float32) / 255.0


def pil_resize(img_array, resolution_wh):
    """Resize a float [H, W, 3] array with PIL's bilinear default."""
    Image = _pillow("resizing an image to the camera resolution")
    img = Image.fromarray(
        np.clip(np.asarray(img_array) * 255.0 + 0.5, 0, 255).astype(np.uint8))
    return np.asarray(img.resize(tuple(resolution_wh)), np.float32) / 255.0


def save_image(path, img):
    """img [H, W, 3] float in [0, 1] -> 8-bit PNG. NaN saves as 0, +inf as
    1 and -inf as 0 (divergent optimisation states can render non-finite
    pixels); values are rounded as clip(x * 255 + 0.5) to uint8."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.nan_to_num(np.asarray(img, np.float32), nan=0.0, posinf=1.0,
                        neginf=0.0)
    png.write_png(path,
                  np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8))
