"""Image loading and saving, and the MASt3R input policy (port of
instantsplat_tpu/data/images.py).

PNG goes through the package's own codec (data/png.py), so PNG scenes need
no Pillow. Other formats (JPEG, ...) and resizing use Pillow when it is
installed and raise a clear error when it is not.

The stage-1 input policy: files sorted by the first integer in the stem;
each image resized so its long side is `size` (512), with LANCZOS going
down and BICUBIC going up, then centre-cropped so both sides are
multiples of 16 (for square inputs without `square_ok`, the crop height
is 3/4 of the width). Pillow's resize to the size an image already has is
a plain copy, so an input whose long side is already `size` needs only
the crop, which is done here without Pillow.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import png

ALLOWED_EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".tiff"}


def _pillow(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"{what} needs Pillow, which is not installed; store the scene's "
            "images as 8-bit PNG (read without Pillow) at the resolution "
            "the stage expects (512 on the long side for stage 1, the one "
            "recorded in cameras.txt for the later stages)") from e
    return Image


def _to_rgb(arr: np.ndarray) -> np.ndarray:
    """uint8 [H, W, C] -> [H, W, 3], as PIL's convert("RGB") does: grey is
    replicated, alpha is dropped (not composited)."""
    if arr.shape[2] in (1, 2):
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return arr[:, :, :3]


def _read_rgb8(path) -> np.ndarray:
    """-> uint8 [H, W, 3]."""
    if Path(path).suffix.lower() == ".png":
        return _to_rgb(png.read_png(path))
    Image = _pillow(f"reading {path}")
    return np.asarray(Image.open(path).convert("RGB"))


def load_image(path) -> np.ndarray:
    """-> [H, W, 3] float32 in [0, 1]."""
    return _read_rgb8(path).astype(np.float32) / 255.0


def pil_resize(img_array, resolution_wh):
    """Resize a float [H, W, 3] array with PIL's bilinear default."""
    Image = _pillow("resizing an image to the camera resolution")
    img = Image.fromarray(
        np.clip(np.asarray(img_array) * 255.0 + 0.5, 0, 255).astype(np.uint8))
    return np.asarray(img.resize(tuple(resolution_wh)), np.float32) / 255.0


def save_image(path, img):
    """img [H, W, 3] float in [0, 1] -> an 8-bit file in the format its
    suffix names (PNG without Pillow, anything else through Pillow). NaN
    saves as 0, +inf as 1 and -inf as 0 (divergent optimisation states can
    render non-finite pixels); values are rounded as clip(x * 255 + 0.5)
    to uint8."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    arr = np.nan_to_num(np.asarray(img, np.float32), nan=0.0, posinf=1.0,
                        neginf=0.0)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if Path(path).suffix.lower() == ".png":
        png.write_png(path, arr)
    else:
        _pillow(f"writing {path}").fromarray(arr).save(path)


# ---------------------------------------------------------------------------
# stage 1: the MASt3R input policy
# ---------------------------------------------------------------------------


def sorted_image_files(image_dir):
    """Numerically sorted image paths + the (first) file suffix."""
    def key(f: Path):
        m = re.search(r"\d+", f.stem)
        return int(m.group()) if m else float("inf")

    files = sorted(
        (f for f in Path(image_dir).iterdir()
         if f.is_file() and f.suffix.lower() in ALLOWED_EXTENSIONS),
        key=key)
    if not files:
        raise FileNotFoundError(f"no images found in {image_dir}")
    return [str(f) for f in files], files[0].suffix


def _resize_long_side(arr: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] with its long side scaled to `size`."""
    h, w = arr.shape[:2]
    scale = size / max(w, h)
    wh = (round(w * scale), round(h * scale))
    if wh == (w, h):
        return arr
    Image = _pillow(f"resizing a {w}x{h} input to {size} on the long side")
    interp = Image.LANCZOS if scale < 1 else Image.BICUBIC
    return np.asarray(Image.fromarray(arr).resize(wh, interp))


def _load_one(path, size, square_ok):
    arr = _read_rgb8(path)
    orig_wh = (arr.shape[1], arr.shape[0])
    arr = _resize_long_side(arr, size)
    h, w = arr.shape[:2]
    cx, cy = w // 2, h // 2
    halfw, halfh = (w // 16) * 8, (h // 16) * 8
    if not square_ok and w == h:
        halfh = 3 * halfw // 4
    arr = arr[cy - halfh:cy + halfh, cx - halfw:cx + halfw]
    return arr.astype(np.float32) / 255.0, orig_wh


def load_images(paths, size=512, square_ok=False):
    """-> (imgs [V, H, W, 3] float32 in [0,1], (H, W), the last image's
    original (W, H)). All images must share one shape after the crop; for
    mixed-aspect folders use `load_images_mixed`."""
    out = []
    orig_wh = None
    for path in paths:
        arr, orig_wh = _load_one(path, size, square_ok)
        out.append(arr)
    shapes = {o.shape for o in out}
    if len(shapes) > 1:
        raise ValueError(
            f"mixed image shapes after resize/crop: {sorted(shapes)} — use "
            "load_images_mixed (pipelines route mixed-aspect scenes "
            "through it automatically).")
    arr = np.stack(out)
    return arr, arr.shape[1:3], orig_wh


def load_images_from_dir(image_dir, size=512):
    """The numerically sorted images of a folder through `load_images`
    -> (imgs, (H, W), original (W, H), files, suffix)."""
    files, suffix = sorted_image_files(image_dir)
    imgs, hw, orig_wh = load_images(files, size=size)
    return imgs, hw, orig_wh, files, suffix


def load_images_mixed(paths, size=512, square_ok=False):
    """-> (imgs: list of [H_i, W_i, 3] float32 in [0,1], shapes [V, 2] int
    (H_i, W_i), org_whs: each image's original (W, H))."""
    imgs, org_whs = [], []
    for path in paths:
        arr, orig_wh = _load_one(path, size, square_ok)
        imgs.append(arr)
        org_whs.append(orig_wh)
    return imgs, np.array([im.shape[:2] for im in imgs], np.int64), org_whs


def pad_to_canvas(maps, canvas_hw=None, fill=0.0):
    """Stack maps of mixed shapes [H_i, W_i, ...] onto one canvas, each at
    the top-left corner; canvas_hw defaults to the largest extent.
    -> [V, Hc, Wc, ...]."""
    if canvas_hw is None:
        canvas_hw = (max(np.asarray(m).shape[0] for m in maps),
                     max(np.asarray(m).shape[1] for m in maps))
    hm, wm = int(canvas_hw[0]), int(canvas_hw[1])
    first = np.asarray(maps[0])
    out = np.full((len(maps), hm, wm) + first.shape[2:], fill, first.dtype)
    for v, m in enumerate(maps):
        h, w = np.asarray(m).shape[:2]
        out[v, :h, :w] = m
    return out
