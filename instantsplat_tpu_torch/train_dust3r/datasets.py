"""Posed multi-view datasets for DUSt3R/MASt3R pre-training (port of
instantsplat_tpu/train_dust3r/datasets.py).

The shared view transform of the reference's loaders (crop on the
principal point, portrait/landscape choice, `aug_crop`, rescale with the
intrinsics, final crop), the colour jitter, GT correspondences from
reprojected pointmaps, the pair-dataset base with the reference's dataset
arithmetic (`a + b`, `n @ a`, `n * a`), the generic posed-RGBD directory
dataset, its synthetic writer and the batch prefetcher. Every random draw
is a numpy `Generator` call in the JAX package's order, so one seed gives
the same batches in both packages. `batches` yields torch CPU tensors in
the JAX package's dict layout; the trainer moves them to the device.

Directory layout per scene:
    <scene>/images/<name>.png        RGB
    <scene>/depth/<name>.npy         [H, W] float32 depth (0 = invalid)
    <scene>/poses.npz                c2w [V, 4, 4], K [V, 3, 3],
                                     names [V] (matching file stems)

Pillow is needed only to resize an image to another size (and, in the
loaders, for JPEG): a resize to the size the image already has is a copy,
as it is in Pillow, and is done here without it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch.data.images import _pillow, load_image, save_image


# -- geometry-aware crop/resize core ---------------------------------------


def camera_matrix_of_crop(K, input_resolution, output_resolution,
                          scaling=1.0, offset_factor=0.5, offset=None):
    """Intrinsics after scaling then cropping to output_resolution.
    Resolutions are (W, H); scaling happens in the pixel-centre
    convention (+0.5) and converts back."""
    margins = (np.asarray(input_resolution, np.float64) * scaling
               - np.asarray(output_resolution, np.float64))
    if not np.all(margins >= -1e-6):
        raise ValueError(f"crop larger than the scaled input: {margins}")
    if offset is None:
        offset = offset_factor * margins
    K2 = np.asarray(K, np.float64).copy()
    K2[0, 2] += 0.5
    K2[1, 2] += 0.5
    K2[:2, :] *= scaling
    K2[:2, 2] -= offset
    K2[0, 2] -= 0.5
    K2[1, 2] -= 0.5
    return K2.astype(np.float32)


def _resize(arr, out_res, resample, mode=None):
    """Pillow's resize of one array to (W, H); the same size is a copy."""
    if tuple(out_res) == (arr.shape[1], arr.shape[0]):
        return np.array(arr)
    Image = _pillow(f"resizing a {arr.shape[1]}x{arr.shape[0]} view to "
                    f"{out_res[0]}x{out_res[1]}")
    pim = Image.fromarray(arr, mode=mode) if mode else Image.fromarray(arr)
    method = {"lanczos": Image.Resampling.LANCZOS,
              "bicubic": Image.Resampling.BICUBIC,
              "nearest": Image.Resampling.NEAREST}[resample]
    return np.asarray(pim.resize(tuple(int(v) for v in out_res),
                                 resample=method))


def rescale_view(img, depth, K, output_resolution, force=True):
    """Jointly rescale (img [H,W,3] float 0..1 or uint8, depth [H,W], K)
    so the output covers `output_resolution` (W, H): Lanczos down /
    bicubic up for the image, nearest for depth."""
    in_res = np.array([img.shape[1], img.shape[0]])
    out = np.asarray(output_resolution, np.float64)
    scale = float(np.max(out / in_res)) + 1e-8
    if scale >= 1 and not force:
        return img, depth, np.asarray(K, np.float32)
    out_res = np.floor(in_res * scale).astype(int)
    u8 = img.dtype == np.uint8
    im8 = img if u8 else (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    img2 = _resize(im8, out_res, "lanczos" if scale < 1 else "bicubic")
    dep = _resize(np.asarray(depth, np.float32), out_res, "nearest",
                  mode="F")
    if not u8:
        img2 = img2.astype(np.float32) / 255.0
    K2 = camera_matrix_of_crop(K, in_res, out_res, scaling=scale)
    return img2, dep, K2


def crop_view(img, depth, K, bbox):
    """Crop (l, t, r, b); the principal point shifts by the crop origin."""
    l, t, r, b = (int(v) for v in bbox)
    K2 = np.asarray(K, np.float32).copy()
    K2[0, 2] -= l
    K2[1, 2] -= t
    return img[t:b, l:r], depth[t:b, l:r], K2


def crop_resize_view(img, depth, K, resolution, rng=None, aug_crop=0):
    """The reference's view transform -> (img, depth, K) at `resolution`
    (W, H), W >= H: a maximal crop centred on the principal point (which
    must not lie within 1/5 of a border); the target transposed for
    portrait inputs (H > 1.1 W) or at random for near-square ones; the
    rescale target enlarged by rng.integers(0, aug_crop); the final
    offset crop."""
    h, w = np.asarray(depth).shape
    K = np.asarray(K, np.float64)
    cx, cy = int(round(K[0, 2])), int(round(K[1, 2]))
    mx, my = min(cx, w - cx), min(cy, h - cy)
    if not (mx > w / 5 and my > h / 5):
        raise ValueError(f"bad principal point ({cx},{cy})")
    img, depth, K = crop_view(img, depth, K,
                              (cx - mx, cy - my, cx + mx, cy + my))
    h, w = depth.shape
    resolution = tuple(int(v) for v in resolution)
    if resolution[0] < resolution[1]:
        raise ValueError(f"resolution {resolution} must be landscape (W>=H)")
    if h > 1.1 * w:
        resolution = resolution[::-1]
    elif 0.9 < h / w < 1.1 and resolution[0] != resolution[1]:
        if rng is not None and rng.integers(2):
            resolution = resolution[::-1]
    target = np.array(resolution)
    if aug_crop > 1 and rng is not None:
        target = target + int(rng.integers(0, aug_crop))
    img, depth, K = rescale_view(img, depth, K, target)
    K2 = camera_matrix_of_crop(
        K, (depth.shape[1], depth.shape[0]), resolution, offset_factor=0.5)
    l = int(round(K[0, 2] - K2[0, 2]))
    t = int(round(K[1, 2] - K2[1, 2]))
    return crop_view(img, depth, K,
                     (l, t, l + resolution[0], t + resolution[1]))


# -- colour augmentation ------------------------------------------------------
# ColorJitter(0.5, 0.5, 0.5, 0.1) as the JAX package draws it. Its HSV
# conversions are matplotlib.colors' (rgb_to_hsv / hsv_to_rgb), copied
# here in numpy with the same arithmetic.


def rgb_to_hsv(arr):
    """(..., 3) RGB in [0, 1] -> HSV in [0, 1]."""
    arr = np.asarray(arr)
    in_shape = arr.shape
    arr = np.array(arr, dtype=np.promote_types(arr.dtype, np.float32),
                   ndmin=2)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    if np.any(arr_max > 1) or arr.min() < 0:
        raise ValueError("RGB input must be in the range [0, 1]")
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    idx = (arr[..., 0] == arr_max) & ipos  # red is max
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    idx = (arr[..., 1] == arr_max) & ipos  # green is max
    out[idx, 0] = 2. + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    idx = (arr[..., 2] == arr_max) & ipos  # blue is max
    out[idx, 0] = 4. + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def hsv_to_rgb(hsv):
    """(..., 3) HSV in [0, 1] -> RGB in [0, 1]."""
    hsv = np.asarray(hsv)
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32),
                   ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # sector -> (r, g, b) sources, in matplotlib's order of assignment
    for idx, (rr, gg, bb) in (
            (i % 6 == 0, (v, t, p)), (i == 1, (q, v, p)),
            (i == 2, (p, v, t)), (i == 3, (p, q, v)),
            (i == 4, (t, p, v)), (i == 5, (v, p, q)),
            (s == 0, (v, v, v))):
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


def color_jitter(img, rng, brightness=0.5, contrast=0.5, saturation=0.5,
                 hue=0.1):
    """Randomised brightness/contrast/saturation/hue jitter of an
    [H,W,3] float image in [0,1], the four applied in a random order like
    torchvision's ColorJitter."""
    img = np.asarray(img, np.float32)

    def do_brightness(x):
        return x * rng.uniform(max(0, 1 - brightness), 1 + brightness)

    def do_contrast(x):
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        gray = float((x @ np.array([0.299, 0.587, 0.114])).mean())
        return gray + (x - gray) * f

    def do_saturation(x):
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        gray = (x @ np.array([0.299, 0.587, 0.114]))[..., None]
        return gray + (x - gray) * f

    def do_hue(x):
        d = rng.uniform(-hue, hue)
        hsv = rgb_to_hsv(np.clip(x, 0.0, 1.0))
        hsv[..., 0] = (hsv[..., 0] + d) % 1.0
        return hsv_to_rgb(hsv)

    ops = [do_brightness, do_contrast, do_saturation, do_hue]
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


# -- GT correspondence extraction ------------------------------------------


def _reproject_flat(pts_world, K, c2w, shape):
    """World points -> clipped flat pixel indices in the target view."""
    h, w = shape
    w2c = np.linalg.inv(np.asarray(c2w, np.float64))
    cam = pts_world.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = cam[:, :2] / cam[:, 2:3]
    px = uv[:, 0] * K[0, 0] + K[0, 2]
    py = uv[:, 1] * K[1, 1] + K[1, 2]
    with np.errstate(invalid="ignore"):
        qx = np.round(np.nan_to_num(px, nan=-1.0)).astype(np.int64)
        qy = np.round(np.nan_to_num(py, nan=-1.0)).astype(np.int64)
    inside = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h) & (cam[:, 2] > 0)
    flat = np.clip(qx, 0, w - 1) + w * np.clip(qy, 0, h - 1)
    return flat, inside


def extract_correspondences_from_pts3d(view1, view2, target_n_corres=None,
                                       rng=None, nneg=0.0):
    """view_k: dict(pts3d [H,W,3] world frame, camera_pose c2w [4,4],
    K [3,3]). -> (xy1 [N,2], xy2 [N,2]) int pixel coordinates of the
    reciprocal reprojections, or with target_n_corres -> (xy1 [T,2],
    xy2 [T,2], valid [T] bool) with an `nneg` share of deliberate
    non-matches (valid=False) and zero rows padding what neither fills."""
    h1, w1 = view1["pts3d"].shape[:2]
    h2, w2 = view2["pts3d"].shape[:2]
    c12, in12 = _reproject_flat(view1["pts3d"], view2["K"],
                                view2["camera_pose"], (h2, w2))
    c21, in21 = _reproject_flat(view2["pts3d"], view1["K"],
                                view1["camera_pose"], (h1, w1))
    recip1 = (c21[c12] == np.arange(len(c12))) & in12
    pos1 = np.flatnonzero(recip1)
    pos2 = c12[pos1]
    recip2 = (c12[c21] == np.arange(len(c21))) & in21

    def unravel(pos, w):
        return np.stack([pos % w, pos // w], -1).astype(np.int32)

    if target_n_corres is None:
        return unravel(pos1, w1), unravel(pos2, w2)

    rng = rng or np.random.default_rng()
    avail_neg = int(min((~recip1).sum(), (~recip2).sum()))
    n_pos = min(len(pos1), int(target_n_corres * (1 - nneg)))
    n_neg = min(target_n_corres - n_pos, avail_neg)
    n_pos = min(target_n_corres - n_neg, len(pos1))
    n_pad = target_n_corres - n_pos - n_neg
    if n_pos < len(pos1):
        perm = rng.permutation(len(pos1))[:n_pos]
        pos1, pos2 = pos1[perm], pos2[perm]
    valid = np.ones(n_pos, bool)
    if n_neg > 0:
        def pick(mask):
            p = (~mask).astype(np.float64)
            return rng.choice(len(mask), size=n_neg, replace=False,
                              p=p / p.sum())

        pos1 = np.concatenate([pos1, pick(recip1)])
        pos2 = np.concatenate([pos2, pick(recip2)])
        valid = np.concatenate([valid, np.zeros(n_neg, bool)])
    if n_pad > 0:
        pos1 = np.concatenate([pos1, np.zeros(n_pad, int)])
        pos2 = np.concatenate([pos2, np.zeros(n_pad, int)])
        valid = np.concatenate([valid, np.zeros(n_pad, bool)])
    return unravel(pos1, w1), unravel(pos2, w2), valid


# -- shared pair-dataset base ------------------------------------------------


def finalize_view(img, depth, K, c2w, rng=None, resolution=None,
                  aug_crop=0, transform=None):
    """RAW view -> training view dict: crop/resize with the intrinsics,
    optional colour jitter, pointmap unprojection, valid mask from
    depth > 0, portrait views transposed to landscape (`true_shape` keeps
    the real orientation)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    depth = np.asarray(depth, np.float32)
    K = np.asarray(K, np.float32)
    c2w = np.asarray(c2w, np.float32)
    if resolution is not None:
        img, depth, K = crop_resize_view(img, depth, K, resolution,
                                         rng=rng, aug_crop=aug_crop)
    if transform == "color_jitter" and rng is not None:
        img = color_jitter(img, rng)
    h, w = depth.shape
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    xy = np.stack([(gx - K[0, 2]) / K[0, 0],
                   (gy - K[1, 2]) / K[1, 1]], -1)
    pts_cam = np.concatenate([xy * depth[..., None], depth[..., None]], -1)
    pts_world = pts_cam.reshape(-1, 3) @ c2w[:3, :3].T + c2w[:3, 3]
    valid = (depth > 0) & np.isfinite(pts_world.reshape(h, w, 3)).all(-1)
    view = dict(
        img=img.astype(np.float32),
        pts3d=np.nan_to_num(pts_world.reshape(h, w, 3)).astype(np.float32),
        camera_pose=c2w,
        valid_mask=valid,
        true_shape=np.int32([h, w]),
        K=np.asarray(K, np.float32),
    )
    if h > w:
        for k in ("img", "pts3d", "valid_mask"):
            view[k] = np.swapaxes(view[k], 0, 1)
    return view


_TRANSFORM_KEYS = ("resolutions", "aug_crop", "n_corres", "nneg",
                   "transform")


def _tensor(arrays):
    return torch.from_numpy(np.ascontiguousarray(np.stack(arrays)))


class PairViewDataset:
    """Base class of the pair datasets. Subclasses set the transform knobs
    (resolutions/aug_crop/n_corres/nneg/transform) and implement
    `__len__` and `_get_views(idx, rng, resolution) -> (view1, view2)`
    (finalised view dicts, usually through `finalize_view`)."""

    resolutions = None
    aug_crop = 0
    n_corres = 0
    nneg = 0.0
    transform = None

    def _init_transform(self, resolution=None, aug_crop=0, n_corres=0,
                        nneg=0.0, transform=None):
        if resolution is not None and not isinstance(resolution, list):
            resolution = [tuple(resolution)]
        self.resolutions = resolution
        self.aug_crop = aug_crop
        self.n_corres = n_corres
        self.nneg = nneg
        if transform not in (None, "color_jitter"):
            raise ValueError(f"unknown transform {transform!r}")
        self.transform = transform

    def _copy_transform(self, dataset):
        for k in _TRANSFORM_KEYS:
            setattr(self, k, getattr(dataset, k))

    def __repr__(self):
        return f"{type(self).__name__}({len(self)} pairs)"

    # dataset arithmetic
    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, factor):
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch: int):
        pass

    def _get_views(self, idx, rng, resolution):
        raise NotImplementedError

    def _finalize(self, img, depth, K, c2w, rng, resolution):
        return finalize_view(img, depth, K, c2w, rng=rng,
                             resolution=resolution, aug_crop=self.aug_crop,
                             transform=self.transform)

    def batches(self, batch_size, seed=0, n_epochs=1, shard=None,
                num_workers: int = 0):
        """Yield batch dicts of torch CPU tensors: img1/img2 [B,H,W,3],
        gt1/gt2 with pts3d, camera_pose, valid_mask (and corres,
        valid_corres with n_corres). `shard=(rank, world)` splits the
        pair list across processes.

        num_workers > 1 fetches a batch's views on a thread pool, each
        view pair with its own child generator spawned from the batch's
        rng: deterministic per (seed, num_workers > 1), but another
        augmentation stream than the sequential path's, as in the JAX
        package."""
        pool = None
        if num_workers and num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            yield from self._batches_impl(batch_size, seed, n_epochs,
                                          shard, pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _batches_impl(self, batch_size, seed, n_epochs, shard, pool):
        for epoch in range(n_epochs):
            self.set_epoch(epoch)
            rng = np.random.default_rng(seed + epoch)
            order = rng.permutation(len(self))
            if shard is not None:
                rank, world = shard
                order = order[rank::world]
            for s in range(0, len(order) - batch_size + 1, batch_size):
                # one resolution per batch, shared by all its views
                res = None
                if self.resolutions is not None:
                    res = self.resolutions[
                        int(rng.integers(len(self.resolutions)))]
                idxs = [int(k) for k in order[s:s + batch_size]]
                if pool is not None:
                    child = rng.spawn(len(idxs))
                    views = list(pool.map(
                        lambda kr: self._get_views(kr[0], kr[1], res),
                        zip(idxs, child)))
                else:
                    views = [self._get_views(k, rng, res) for k in idxs]
                v1s = [v[0] for v in views]
                v2s = [v[1] for v in views]

                def gt(vs):
                    return dict(
                        pts3d=_tensor([v["pts3d"] for v in vs]),
                        camera_pose=_tensor([v["camera_pose"] for v in vs]),
                        valid_mask=_tensor([v["valid_mask"] for v in vs]))

                out = dict(img1=_tensor([v["img"] for v in v1s]),
                           img2=_tensor([v["img"] for v in v2s]),
                           gt1=gt(v1s), gt2=gt(v2s))
                if self.n_corres:
                    c1s, c2s, cvs = [], [], []
                    for va, vb in zip(v1s, v2s):
                        xy1, xy2, cv = self._pair_corres(va, vb, rng)
                        c1s.append(xy1)
                        c2s.append(xy2)
                        cvs.append(cv)
                    out["gt1"]["corres"] = _tensor(c1s)
                    out["gt1"]["valid_corres"] = _tensor(cvs)
                    out["gt2"]["corres"] = _tensor(c2s)
                yield out

    def _pair_corres(self, v1, v2, rng):
        """Fixed-count GT correspondences of one view pair. Transposed
        (portrait) views are un-transposed for the round trip and their
        (x, y) swapped back into the stored layout."""
        def orient(v):
            t = bool(v["true_shape"][0] > v["true_shape"][1])
            pts = np.asarray(v["pts3d"])
            return dict(pts3d=np.swapaxes(pts, 0, 1) if t else pts,
                        K=v["K"], camera_pose=v["camera_pose"]), t

        o1, t1 = orient(v1)
        o2, t2 = orient(v2)
        xy1, xy2, cv = extract_correspondences_from_pts3d(
            o1, o2, target_n_corres=self.n_corres, rng=rng,
            nneg=self.nneg)
        if t1:
            xy1 = xy1[:, ::-1]
        if t2:
            xy2 = xy2[:, ::-1]
        return xy1, xy2, cv


class MulDataset(PairViewDataset):
    """`n * dataset`: each element n times."""

    def __init__(self, multiplicator, dataset):
        if not (isinstance(multiplicator, int) and multiplicator > 0):
            raise ValueError(f"bad multiplicator {multiplicator!r}")
        self.multiplicator = multiplicator
        self.dataset = dataset
        self._copy_transform(dataset)

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    def _get_views(self, idx, rng, resolution):
        return self.dataset._get_views(idx // self.multiplicator, rng,
                                       resolution)


class ResizedDataset(PairViewDataset):
    """`n @ dataset`: size n, resampled (with repeats if n > len) each
    epoch from `default_rng(777 + epoch)`."""

    def __init__(self, size, dataset):
        if not (isinstance(size, int) and size > 0):
            raise ValueError(f"bad size {size!r}")
        self.size = size
        self.dataset = dataset
        self._copy_transform(dataset)
        self.set_epoch(0)

    def __len__(self):
        return self.size

    def __repr__(self):
        k = (len(str(self.size)) - 1) // 3
        suffix = ["", "K", "M", "G"][k]
        return f"{self.size // 1000 ** k}{suffix} @ {self.dataset!r}"

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)
        rng = np.random.default_rng(777 + epoch)
        n = len(self.dataset)
        reps = (self.size + n - 1) // n
        pool = np.concatenate(
            [rng.permutation(n) for _ in range(reps)])
        self._idxs = pool[: self.size]

    def _get_views(self, idx, rng, resolution):
        return self.dataset._get_views(int(self._idxs[idx]), rng,
                                       resolution)


class CatDataset(PairViewDataset):
    """`a + b`: concatenation. The children must share one transform
    configuration so batches keep one shape."""

    def __init__(self, datasets):
        flat = []
        for d in datasets:
            flat.extend(d.datasets if isinstance(d, CatDataset) else [d])
        self.datasets = flat
        for k in _TRANSFORM_KEYS:
            vals = [getattr(d, k) for d in flat]
            if not all(v == vals[0] for v in vals):
                raise ValueError(
                    f"concatenated datasets disagree on {k}: {vals}")
            setattr(self, k, vals[0])
        self._cum = np.cumsum([len(d) for d in flat])

    def __len__(self):
        return int(self._cum[-1])

    def __repr__(self):
        return " + ".join(repr(d) for d in self.datasets)

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    def _get_views(self, idx, rng, resolution):
        di = int(np.searchsorted(self._cum, idx, side="right"))
        base = 0 if di == 0 else int(self._cum[di - 1])
        return self.datasets[di]._get_views(idx - base, rng, resolution)


class PosedMultiViewDataset(PairViewDataset):
    def __init__(self, root, scenes=None, pair_window=3, resolution=None,
                 aug_crop=0, n_corres=0, nneg=0.0, transform=None):
        """Pairs (i, i+d) and (i+d, i), 1 <= d <= pair_window, of every
        scene under `root`. resolution: an optional (W, H) target, or a
        list of them with one drawn per batch; aug_crop > 1 enlarges the
        rescale target at random; n_corres > 0 adds fixed-count GT
        correspondences with an `nneg` share of negatives;
        transform='color_jitter' jitters the images."""
        self._init_transform(resolution, aug_crop, n_corres, nneg,
                             transform)
        self.root = Path(root)
        self.scenes = []
        scene_dirs = ([self.root / s for s in scenes] if scenes
                      else sorted(p for p in self.root.iterdir()
                                  if p.is_dir()))
        for sdir in scene_dirs:
            meta = np.load(sdir / "poses.npz")
            names = [str(n) for n in meta["names"]]
            self.scenes.append(dict(
                dir=sdir, names=names,
                c2w=np.asarray(meta["c2w"], np.float32),
                K=np.asarray(meta["K"], np.float32),
            ))
        self.pair_window = pair_window
        self.pairs = []
        for si, sc in enumerate(self.scenes):
            v = len(sc["names"])
            for i in range(v):
                for d in range(1, pair_window + 1):
                    if i + d < v:
                        self.pairs.append((si, i, i + d))
                        self.pairs.append((si, i + d, i))

    def __len__(self):
        return len(self.pairs)

    def _load_view(self, scene, idx, rng=None, resolution=None):
        name = scene["names"][idx]
        img = load_image(scene["dir"] / "images" / f"{name}.png")
        depth = np.load(scene["dir"] / "depth" / f"{name}.npy")
        if resolution is None and self.resolutions is not None:
            resolution = self.resolutions[0]
        return self._finalize(img, depth, scene["K"][idx],
                              scene["c2w"][idx], rng, resolution)

    def _get_views(self, idx, rng, resolution):
        si, i, j = self.pairs[idx]
        scene = self.scenes[si]
        return (self._load_view(scene, i, rng, resolution=resolution),
                self._load_view(scene, j, rng, resolution=resolution))


def synthetic_views(n_views, h, w, focal, seed=0):
    """Geometrically consistent synthetic views (a fronto-parallel plane
    at z=4 seen from shifted cameras), the geometry of every synthetic
    writer. -> list of dict(img u8 [H,W,3], depth f32 [H,W], K, c2w)."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                 np.float32)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for v in range(n_views):
        ang = 0.08 * v
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [np.sin(ang), 0, -0.2 * v]
        dirs = np.stack([(gx - w / 2) / focal, (gy - h / 2) / focal,
                         np.ones_like(gx)], -1) @ c2w[:3, :3].T
        depth = ((4.0 - c2w[2, 3]) / dirs[..., 2]).astype(np.float32)
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        out.append(dict(img=img, depth=depth, K=K, c2w=c2w))
    return out


def write_synthetic_scene(root, name="scene0", n_views=6, h=32, w=48,
                          focal=40.0, seed=0):
    """Write a synthetic posed-RGBD scene in the dataset layout (PNG
    images, .npy depths; no Pillow needed)."""
    sdir = Path(root) / name
    (sdir / "images").mkdir(parents=True, exist_ok=True)
    (sdir / "depth").mkdir(parents=True, exist_ok=True)
    views = synthetic_views(n_views, h, w, focal, seed)
    names = []
    for v, view in enumerate(views):
        name_v = f"f{v:04d}"
        save_image(sdir / "images" / f"{name_v}.png",
                   view["img"].astype(np.float32) / 255.0)
        np.save(sdir / "depth" / f"{name_v}.npy", view["depth"])
        names.append(name_v)
    np.savez(sdir / "poses.npz",
             c2w=np.stack([v["c2w"] for v in views]),
             K=np.stack([v["K"] for v in views]),
             names=np.array(names))
    return sdir


def prefetch_iter(gen, depth: int = 2):
    """Background-thread batch prefetcher: assembles up to `depth`
    batches ahead while the consumer's train step runs. Order-preserving;
    an exception in the producer re-raises at the consumer's next pull.

    When the consumer abandons the iterator (generator .close(), e.g. the
    train loop reached its step count), the producer is told to stop and
    the wrapped generator is closed, so its resources (the dataset's
    worker pool, queued batches) are released instead of a thread
    blocking forever on a full queue."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    _END = object()
    stop = threading.Event()

    def put_or_abandoned(obj) -> bool:
        """Bounded put that notices abandonment; True = delivered."""
        while not stop.is_set():
            try:
                q.put(obj, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put_or_abandoned(item):
                    break
            else:
                put_or_abandoned(_END)
        except BaseException as e:  # handed to the consumer, which raises
            put_or_abandoned(e)
        finally:
            if stop.is_set():
                # run the generator's finally blocks (closes worker pools)
                close = getattr(gen, "close", None)
                if close is not None:
                    close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # unblock a producer waiting on a full queue
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
