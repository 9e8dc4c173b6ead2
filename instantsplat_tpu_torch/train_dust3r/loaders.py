"""Pre-training dataset loaders for the preprocessed DUSt3R data layouts
(port of instantsplat_tpu/train_dust3r/loaders.py).

Co3d, WildRGBD, ScanNetpp, ARKitScenes, BlendedMVS, MegaDepth, Waymo,
StaticThings3D and Habitat each read the on-disk layout the reference's
`datasets_preprocess/` scripts produce, apply the shared view transform
(datasets.finalize_view) and yield batches through the PairViewDataset
machinery; every random draw is the JAX package's, in its order.
`make_dataset("Co3d(...) + 10 @ ...")` evaluates the reference's spec
string over the same names.

Files: 16-bit depth PNGs and PNG masks through the package's own codec
(data/png.py), JPEG through Pillow (a clear error without it), EXR
through data/exr.py. The `write_synthetic_*` writers produce tiny scenes
in each layout for tests and smoke runs.
"""

from __future__ import annotations

import itertools
import json
import os.path as osp
from collections import deque
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import png
from instantsplat_tpu_torch.data.exr import read_exr, write_exr
from instantsplat_tpu_torch.data.images import _pillow
from instantsplat_tpu_torch.data.images import _read_rgb8 as _imread  # RGB u8
from instantsplat_tpu_torch.train_dust3r.datasets import (  # noqa: F401
    CatDataset,
    MulDataset,
    PairViewDataset,
    PosedMultiViewDataset,
    ResizedDataset,
    synthetic_views as _synth_views,
)

__all__ = [
    "Co3d", "WildRGBD", "ScanNetpp", "ARKitScenes", "BlendedMVS",
    "MegaDepth", "Waymo", "StaticThings3D", "Habitat", "make_dataset",
]


def _png16(path):
    """16-bit greyscale PNG -> float32 raw values."""
    return png.read_png16(path).astype(np.float32)


def _png16_write(path, arr):
    png.write_png16(path, np.asarray(arr, np.uint16))


class Co3d(PairViewDataset):
    """Preprocessed Co3D v2 (dust3r/datasets/co3d.py).

    Layout: <ROOT>/selected_seqs_{split}.json (obj -> instance ->
    image pool); per view `images/frame{v:06d}.jpg` +
    `images/frame{v:06d}.npz` (camera_pose, camera_intrinsics,
    maximum_depth), `depths/frame{v:06d}.jpg.geometric.png` (u16 /
    65535 * maximum_depth), `masks/frame{v:06d}.png`. Pairs are circular
    combinations 0 < |i-j| <= 30, |i-j| % 5 == 0 over a 100-image pool
    (co3d.py:39-43) with +-4 index jitter at load; all-invalid depths
    invalidate the image and retry a neighbor (co3d.py:85-127)."""

    dataset_label = "Co3d_v2"

    def __init__(self, ROOT, split="train", mask_bg=True, **kw):
        self._init_transform(**kw)
        if mask_bg not in (True, False, "rand"):
            raise ValueError(f"mask_bg must be True, False or 'rand', not "
                             f"{mask_bg!r}")
        self.ROOT = str(ROOT)
        self.mask_bg = mask_bg
        with open(osp.join(self.ROOT, f"selected_seqs_{split}.json")) as f:
            scenes = json.load(f)
        scenes = {(k, k2): v2 for k, v in scenes.items() if len(v) > 0
                  for k2, v2 in v.items()}
        self.scenes = scenes
        self.scene_list = list(scenes.keys())
        self.combinations = [
            (i, j) for i, j in itertools.combinations(range(100), 2)
            if 0 < abs(i - j) <= 30 and abs(i - j) % 5 == 0
        ]
        self.invalidate = {s: {} for s in self.scene_list}

    # per-view path scheme (overridden by WildRGBD)
    def _impath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{v:06d}.jpg")

    def _metapath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "images",
                        f"frame{v:06d}.npz")

    def _depthpath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "depths",
                        f"frame{v:06d}.jpg.geometric.png")

    def _maskpath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "masks",
                        f"frame{v:06d}.png")

    def _read_depth(self, depthpath, meta):
        d = _png16(depthpath)
        return (d / 65535.0) * np.nan_to_num(float(meta["maximum_depth"]))

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    def _get_views(self, idx, rng, resolution):
        obj, instance = self.scene_list[idx // len(self.combinations)]
        pool = self.scenes[obj, instance]
        i1, i2 = self.combinations[idx % len(self.combinations)]
        last = len(pool) - 1
        inval = self.invalidate[obj, instance].setdefault(
            resolution, [False] * len(pool))
        mask_bg = (self.mask_bg is True) or (
            self.mask_bg == "rand" and rng.choice(2))

        views = []
        # jittered indices; deque-pop order = (i1, i2) like the reference
        idxs = deque(max(0, min(i + int(rng.integers(-4, 5)), last))
                     for i in (i2, i1))
        while idxs:
            im = idxs.pop()
            if inval[im]:  # walk to the nearest valid neighbor
                step = 2 * int(rng.choice(2)) - 1
                for off in range(1, len(pool)):
                    cand = (im + step * off) % len(pool)
                    if not inval[cand]:
                        im = cand
                        break
            v = pool[im]
            meta = np.load(self._metapath(obj, instance, v))
            img = _imread(self._impath(obj, instance, v))
            depth = self._read_depth(self._depthpath(obj, instance, v),
                                     meta)
            if mask_bg:
                m = _imread(self._maskpath(obj, instance, v))[..., 0]
                depth = depth * ((m / 255.0) > 0.1)
            view = self._finalize(img, depth,
                                  meta["camera_intrinsics"],
                                  meta["camera_pose"], rng, resolution)
            if not view["valid_mask"].any():
                inval[im] = True
                idxs.append(im)
                continue
            views.append(view)
        return views[0], views[1]


class WildRGBD(Co3d):
    """Preprocessed WildRGBD (dust3r/datasets/wildrgbd.py) — the Co3D
    machinery with rgb/depth/masks/metadata path scheme and depth in
    millimeters (u16 / 1000)."""

    dataset_label = "WildRGBD"

    def _impath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "rgb", f"{v:0>5d}.jpg")

    def _metapath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "metadata",
                        f"{v:0>5d}.npz")

    def _depthpath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "depth", f"{v:0>5d}.png")

    def _maskpath(self, obj, instance, v):
        return osp.join(self.ROOT, obj, instance, "masks", f"{v:0>5d}.png")

    def _read_depth(self, depthpath, meta):
        return _png16(depthpath) / 1000.0


class _MetadataPairs(PairViewDataset):
    """Shared machinery for the all_metadata.npz layouts (ScanNet++ /
    ARKitScenes): scenes, sceneids, images, intrinsics, trajectories,
    pairs[:, :2] in one npz; per-view jpg + u16 millimeter depth png."""

    dataset_label = "?"

    def _load_metadata(self, root):
        with np.load(osp.join(root, "all_metadata.npz")) as data:
            self.scenes = [str(s) for s in data["scenes"]]
            self.sceneids = data["sceneids"]
            self.images = [str(s) for s in data["images"]]
            self.intrinsics = data["intrinsics"].astype(np.float32)
            self.trajectories = data["trajectories"].astype(np.float32)
            self.pairs = data["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def _paths(self, scene_dir, basename):
        raise NotImplementedError

    def _get_views(self, idx, rng, resolution):
        views = []
        for vi in self.pairs[idx]:
            scene_dir = osp.join(self._root, self.scenes[self.sceneids[vi]])
            impath, dpath = self._paths(scene_dir, self.images[vi])
            img = _imread(impath)
            depth = _png16(dpath) / 1000.0
            depth[~np.isfinite(depth)] = 0
            views.append(self._finalize(img, depth, self.intrinsics[vi],
                                        self.trajectories[vi], rng,
                                        resolution))
        return views[0], views[1]


class ScanNetpp(_MetadataPairs):
    """Preprocessed ScanNet++ (dust3r/datasets/scannetpp.py): train split
    only; `<scene>/images/<name>.jpg` + `<scene>/depth/<name>.png`."""

    dataset_label = "ScanNet++"

    def __init__(self, ROOT, split="train", **kw):
        self._init_transform(**kw)
        if split != "train":
            raise ValueError("ScanNet++ has a train split only")
        self._root = str(ROOT)
        self._load_metadata(self._root)

    def _paths(self, scene_dir, basename):
        return (osp.join(scene_dir, "images", basename + ".jpg"),
                osp.join(scene_dir, "depth", basename + ".png"))


class ARKitScenes(_MetadataPairs):
    """Preprocessed ARKitScenes (dust3r/datasets/arkitscenes.py):
    Training/Test split dirs; `vga_wide/<name .png->.jpg>` +
    `lowres_depth/<name>.png`."""

    dataset_label = "arkitscenes"

    def __init__(self, ROOT, split="train", **kw):
        self._init_transform(**kw)
        sub = {"train": "Training", "test": "Test"}[split]
        self._root = osp.join(str(ROOT), sub)
        self._load_metadata(self._root)

    def _paths(self, scene_dir, basename):
        return (osp.join(scene_dir, "vga_wide",
                         basename.replace(".png", ".jpg")),
                osp.join(scene_dir, "lowres_depth", basename))


class _JpgExrNpz(PairViewDataset):
    """Shared per-view reader for the <stem>.jpg / <stem>.exr /
    <stem>.npz triple layouts (BlendedMVS / MegaDepth / Waymo)."""

    def _read_view(self, seq_path, stem, rng, resolution):
        img = _imread(osp.join(seq_path, stem + ".jpg"))
        depth = read_exr(osp.join(seq_path, stem + ".exr"))
        cam = np.load(osp.join(seq_path, stem + ".npz"))
        K = np.float32(cam["intrinsics"])
        if "cam2world" in cam:
            c2w = np.float32(cam["cam2world"])
        else:  # BlendedMVS stores R/t separately
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = cam["R_cam2world"]
            c2w[:3, 3] = cam["t_cam2world"]
        return self._finalize(img, depth, K, c2w, rng, resolution)


class BlendedMVS(_JpgExrNpz):
    """Preprocessed BlendedMVS (dust3r/datasets/blendedmvs.py):
    `blendedmvs_pairs.npy` structured pair list; scene dir
    `{seqh:08x}{seql:016x}`; views `{v:08d}.jpg/.exr/.npz`; train/val
    split by seq_low % 10 (blendedmvs.py:26-38)."""

    dataset_label = "BlendedMVS"

    def __init__(self, ROOT, split=None, **kw):
        self._init_transform(**kw)
        self.ROOT = str(ROOT)
        pairs = np.load(osp.join(self.ROOT, "blendedmvs_pairs.npy"))
        if split == "train":
            pairs = pairs[(pairs["seq_low"] % 10) > 0]
        elif split == "val":
            pairs = pairs[(pairs["seq_low"] % 10) == 0]
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, rng, resolution):
        seqh, seql, img1, img2, _score = self.pairs[idx]
        seq_path = osp.join(self.ROOT, f"{seqh:08x}{seql:016x}")
        return tuple(self._read_view(seq_path, f"{v:08d}", rng, resolution)
                     for v in (img1, img2))


class MegaDepth(_JpgExrNpz):
    """Preprocessed MegaDepth (dust3r/datasets/megadepth.py):
    all_metadata.npz (scenes 'scene subscene', images, pairs); train =
    everything NOT in scenes 0015/0022, val = those two
    (megadepth.py:23-29)."""

    dataset_label = "MegaDepth"

    def __init__(self, ROOT, split=None, **kw):
        self._init_transform(**kw)
        self.ROOT = str(ROOT)
        with np.load(osp.join(self.ROOT, "all_metadata.npz")) as data:
            self.all_scenes = [str(s) for s in data["scenes"]]
            self.all_images = [str(s) for s in data["images"]]
            self.pairs = data["pairs"]
        if split in ("train", "val"):
            sel = np.array([s.startswith(("0015", "0022"))
                            for s in self.all_scenes])
            valid = np.isin(self.pairs["scene_id"], np.nonzero(sel)[0])
            self.pairs = self.pairs[~valid if split == "train" else valid]

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, rng, resolution):
        scene_id, im1, im2, _score = self.pairs[idx]
        scene, subscene = self.all_scenes[scene_id].split()
        seq_path = osp.join(self.ROOT, scene, subscene)
        return tuple(
            self._read_view(seq_path, self.all_images[v], rng, resolution)
            for v in (im1, im2))


class Waymo(_JpgExrNpz):
    """Preprocessed Waymo Open (dust3r/datasets/waymo.py):
    waymo_pairs.npz (scenes, frames, pairs (scene_id, i1, i2))."""

    dataset_label = "Waymo"

    def __init__(self, ROOT, split=None, **kw):
        self._init_transform(**kw)
        self.ROOT = str(ROOT)
        with np.load(osp.join(self.ROOT, "waymo_pairs.npz")) as data:
            self.scenes = [str(s) for s in data["scenes"]]
            self.frames = [str(s) for s in data["frames"]]
            self.pairs = data["pairs"]

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, rng, resolution):
        seq, i1, i2 = self.pairs[idx]
        seq_path = osp.join(self.ROOT, self.scenes[seq])
        return tuple(
            self._read_view(seq_path, self.frames[v], rng, resolution)
            for v in (i1, i2))


class StaticThings3D(PairViewDataset):
    """Preprocessed StaticThings3D (dust3r/datasets/staticthings3d.py):
    staticthings_pairs.npy (scene, seq, cam1, im1, cam2, im2); views at
    TRAIN/<scene>/{seq:04d}/<left|right>/{v:04d}_{clean|final}.jpg +
    .exr + .npz; mask_bg zeroes depth > 200; the clean/final render is
    drawn at random per view (staticthings3d.py:36-47)."""

    dataset_label = "StaticThings3D"

    def __init__(self, ROOT, mask_bg="rand", **kw):
        self._init_transform(**kw)
        if mask_bg not in (True, False, "rand"):
            raise ValueError(f"mask_bg must be True, False or 'rand', not "
                             f"{mask_bg!r}")
        self.ROOT = str(ROOT)
        self.mask_bg = mask_bg
        self.pairs = np.load(osp.join(self.ROOT, "staticthings_pairs.npy"))

    def __len__(self):
        return len(self.pairs)

    def _get_views(self, idx, rng, resolution):
        scene, seq, cam1, im1, cam2, im2 = self.pairs[idx]
        scene = (scene.decode("ascii") if isinstance(scene, bytes)
                 else str(scene))
        seq_path = osp.join("TRAIN", scene, f"{seq:04d}")
        mask_bg = (self.mask_bg is True) or (
            self.mask_bg == "rand" and rng.choice(2))
        cam_name = {b"l": "left", b"r": "right", "l": "left", "r": "right"}
        views = []
        for cam, im in ((cam_name[cam1], im1), (cam_name[cam2], im2)):
            num = f"{im:04d}"
            variant = "_clean.jpg" if rng.choice(2) else "_final.jpg"
            base = osp.join(self.ROOT, seq_path, cam, num)
            img = _imread(base + variant)
            depth = read_exr(base + ".exr")
            cp = np.load(base + ".npz")
            if mask_bg:
                depth = np.where(depth > 200, 0.0, depth)
            views.append(self._finalize(img, depth, cp["intrinsics"],
                                        cp["cam2world"], rng, resolution))
        return views[0], views[1]


class Habitat(PairViewDataset):
    """Preprocessed Habitat renders (dust3r/datasets/habitat.py): scene
    list `Habitat_{size}_scenes_{split}.txt`; per scene key 5 views
    `{key}_{v}.jpeg` / `{key}_{v}_depth.exr` /
    `{key}_{v}_camera_params.json`; a pair = view 0 + one random other
    (view 0 is connected with all), skipping broken (non-finite-pose)
    views (habitat.py:41-55)."""

    dataset_label = "Habitat"

    def __init__(self, size, ROOT, split="train", **kw):
        self._init_transform(**kw)
        self.ROOT = str(ROOT)
        with open(osp.join(self.ROOT,
                           f"Habitat_{size}_scenes_{split}.txt")) as f:
            self.scenes = f.read().splitlines()
        self.instances = list(range(1, 5))

    def __len__(self):
        return len(self.scenes)

    def _load_one(self, data_path, key, view_index, rng, resolution):
        view_index += 1  # file indices start at 1
        img = _imread(osp.join(data_path, f"{key}_{view_index}.jpeg"))
        depth = read_exr(osp.join(data_path, f"{key}_{view_index}_depth.exr"))
        with open(osp.join(data_path,
                           f"{key}_{view_index}_camera_params.json")) as f:
            cam = json.load(f)
        K = np.float32(cam["camera_intrinsics"])
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = cam["R_cam2world"]
        c2w[:3, 3] = cam["t_cam2world"]
        return img, depth, K, c2w

    def _get_views(self, idx, rng, resolution):
        scene = self.scenes[idx]
        data_path, key = osp.split(osp.join(self.ROOT, scene))
        views = []
        for vi in (0, int(rng.choice(self.instances))):
            for ii in range(vi, vi + 5):  # skip broken views
                img, depth, K, c2w = self._load_one(
                    data_path, key, ii % 5, rng, resolution)
                if np.isfinite(c2w).all():
                    break
            views.append(self._finalize(img, depth, K, c2w, rng,
                                        resolution))
        return views[0], views[1]


def make_dataset(spec: str) -> PairViewDataset:
    """Build a (possibly combined) dataset from the reference's training
    spec string, e.g. \"10 @ Co3d(ROOT='...', resolution=[(224, 224)]) +
    ScanNetpp(ROOT='...')\" (dust3r/datasets/__init__.py:20-22 eval)."""
    namespace = {c.__name__: c for c in (
        Co3d, WildRGBD, ScanNetpp, ARKitScenes, BlendedMVS, MegaDepth,
        Waymo, StaticThings3D, Habitat, PosedMultiViewDataset)}
    return eval(spec, {"__builtins__": {}}, namespace)


# ---------------------------------------------------------------------------
# Synthetic fixture writers, one per layout: tiny geometrically consistent
# scenes (fronto-parallel plane at z=4 seen from shifted cameras, same
# geometry as datasets.write_synthetic_scene) in each loader's exact
# on-disk format for tests and smoke pre-training runs.
# ---------------------------------------------------------------------------


def _write_selected_seqs(root, obj, instance, n_views):
    """Co3D-family scene index: a 100-slot image pool cycling the views
    (the reference's pair combinations assume 100-image pools)."""
    pool = (list(range(n_views)) * (100 // n_views + 1))[:100]
    sel = {obj: {instance: pool}}
    for split in ("train", "test"):
        with open(Path(root) / f"selected_seqs_{split}.json", "w") as f:
            json.dump(sel, f)


def _save_jpg(path, img_u8):
    """An 8-bit RGB file in the format its suffix names: PNG through the
    package's codec, JPEG (quality 92) through Pillow."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if Path(path).suffix.lower() == ".png":
        png.write_png(path, img_u8)
    else:
        _pillow(f"writing {path}").fromarray(img_u8).save(path, quality=92)


def write_synthetic_co3d(root, obj="chair", instance="i0", n_views=8,
                         h=24, w=32, focal=24.0, seed=0):
    root = Path(root)
    views = _synth_views(n_views, h, w, focal, seed)
    max_depth = float(max(v["depth"].max() for v in views)) * 1.1
    for v, view in enumerate(views):
        base = root / obj / instance
        _save_jpg(base / "images" / f"frame{v:06d}.jpg", view["img"])
        np.savez(base / "images" / f"frame{v:06d}.npz",
                 camera_pose=view["c2w"],
                 camera_intrinsics=view["K"],
                 maximum_depth=np.float64(max_depth))
        (base / "depths").mkdir(parents=True, exist_ok=True)
        _png16_write(base / "depths" / f"frame{v:06d}.jpg.geometric.png",
                     np.clip(view["depth"] / max_depth, 0, 1) * 65535)
        (base / "masks").mkdir(parents=True, exist_ok=True)
        _save_jpg(base / "masks" / f"frame{v:06d}.png",
                  np.full((h, w, 3), 255, np.uint8))
    _write_selected_seqs(root, obj, instance, n_views)
    return root


def write_synthetic_wildrgbd(root, obj="toy", instance="i0", n_views=8,
                             h=24, w=32, focal=24.0, seed=0):
    root = Path(root)
    views = _synth_views(n_views, h, w, focal, seed)
    for v, view in enumerate(views):
        base = root / obj / instance
        _save_jpg(base / "rgb" / f"{v:05d}.jpg", view["img"])
        (base / "metadata").mkdir(parents=True, exist_ok=True)
        np.savez(base / "metadata" / f"{v:05d}.npz",
                 camera_pose=view["c2w"], camera_intrinsics=view["K"],
                 maximum_depth=np.float64(10.0))
        (base / "depth").mkdir(parents=True, exist_ok=True)
        _png16_write(base / "depth" / f"{v:05d}.png",
                     view["depth"] * 1000.0)
        (base / "masks").mkdir(parents=True, exist_ok=True)
        _save_jpg(base / "masks" / f"{v:05d}.png",
                  np.full((h, w, 3), 255, np.uint8))
    _write_selected_seqs(root, obj, instance, n_views)
    return root


def _write_metadata_layout(root, img_subdir, depth_subdir, n_views, h, w,
                           focal, seed, img_ext=".jpg", name_ext=""):
    root = Path(root)
    views = _synth_views(n_views, h, w, focal, seed)
    scene = "scene0"
    names, intr, traj, pairs = [], [], [], []
    for v, view in enumerate(views):
        name = f"fr{v:04d}{name_ext}"
        names.append(name)
        stem = name.replace(".png", "") if img_ext == ".jpg" else name
        _save_jpg(root / scene / img_subdir / (stem + img_ext), view["img"])
        (root / scene / depth_subdir).mkdir(parents=True, exist_ok=True)
        _png16_write(root / scene / depth_subdir
                     / (name if name_ext else name + ".png"),
                     view["depth"] * 1000.0)
        intr.append(view["K"])
        traj.append(view["c2w"])
    for i in range(n_views - 1):
        pairs.append((i, i + 1))
    np.savez(root / "all_metadata.npz",
             scenes=np.array([scene]),
             sceneids=np.zeros(n_views, int),
             images=np.array(names),
             intrinsics=np.stack(intr),
             trajectories=np.stack(traj),
             pairs=np.array(pairs, int))
    return root


def write_synthetic_scannetpp(root, n_views=6, h=24, w=32, focal=24.0,
                              seed=0):
    return _write_metadata_layout(root, "images", "depth", n_views, h, w,
                                  focal, seed)


def write_synthetic_arkitscenes(root, split="Training", n_views=6, h=24,
                                w=32, focal=24.0, seed=0):
    _write_metadata_layout(Path(root) / split, "vga_wide", "lowres_depth",
                           n_views, h, w, focal, seed, name_ext=".png")
    return Path(root)


def write_synthetic_blendedmvs(root, n_views=6, h=24, w=32, focal=24.0,
                               seed=0):
    root = Path(root)
    seqh, seql = 0, 1
    seq = f"{seqh:08x}{seql:016x}"
    views = _synth_views(n_views, h, w, focal, seed)
    for v, view in enumerate(views):
        base = root / seq
        _save_jpg(base / f"{v:08d}.jpg", view["img"])
        write_exr(base / f"{v:08d}.exr", view["depth"])
        np.savez(base / f"{v:08d}.npz", intrinsics=view["K"],
                 R_cam2world=view["c2w"][:3, :3],
                 t_cam2world=view["c2w"][:3, 3])
    pairs = np.array(
        [(seqh, seql, i, i + 1, 1.0) for i in range(n_views - 1)],
        dtype=[("seq_high", "i8"), ("seq_low", "i8"), ("im1", "i4"),
               ("im2", "i4"), ("score", "f4")])
    np.save(root / "blendedmvs_pairs.npy", pairs)
    return root


def write_synthetic_megadepth(root, n_views=6, h=24, w=32, focal=24.0,
                              seed=0):
    root = Path(root)
    scene, subscene = "0001", "dense0"
    views = _synth_views(n_views, h, w, focal, seed)
    names = []
    for v, view in enumerate(views):
        name = f"im{v:04d}"
        names.append(name)
        base = root / scene / subscene
        _save_jpg(base / f"{name}.jpg", view["img"])
        write_exr(base / f"{name}.exr", view["depth"])
        np.savez(base / f"{name}.npz", intrinsics=view["K"],
                 cam2world=view["c2w"])
    pairs = np.array([(0, i, i + 1, 1.0) for i in range(n_views - 1)],
                     dtype=[("scene_id", "i4"), ("im1_id", "i4"),
                            ("im2_id", "i4"), ("score", "f4")])
    np.savez(root / "all_metadata.npz",
             scenes=np.array([f"{scene} {subscene}"]),
             images=np.array(names), pairs=pairs)
    return root


def write_synthetic_waymo(root, n_views=6, h=24, w=32, focal=24.0, seed=0):
    root = Path(root)
    scene = "seg0"
    views = _synth_views(n_views, h, w, focal, seed)
    frames = []
    for v, view in enumerate(views):
        frame = f"cam1_{v:04d}"
        frames.append(frame)
        base = root / scene
        _save_jpg(base / f"{frame}.jpg", view["img"])
        write_exr(base / f"{frame}.exr", view["depth"])
        np.savez(base / f"{frame}.npz", intrinsics=view["K"],
                 cam2world=view["c2w"])
    np.savez(root / "waymo_pairs.npz", scenes=np.array([scene]),
             frames=np.array(frames),
             pairs=np.array([(0, i, i + 1) for i in range(n_views - 1)],
                            int))
    return root


def write_synthetic_staticthings3d(root, n_views=4, h=24, w=32,
                                   focal=24.0, seed=0):
    root = Path(root)
    scene, seq = "A/0000", 0
    views = _synth_views(n_views, h, w, focal, seed)
    for v, view in enumerate(views):
        for cam in ("left", "right"):
            base = root / "TRAIN" / scene / f"{seq:04d}" / cam
            _save_jpg(base / f"{v:04d}_clean.jpg", view["img"])
            _save_jpg(base / f"{v:04d}_final.jpg", view["img"])
            write_exr(base / f"{v:04d}.exr", view["depth"])
            np.savez(base / f"{v:04d}.npz", intrinsics=view["K"],
                     cam2world=view["c2w"])
    pairs = np.array(
        [(scene.encode(), seq, b"l", i, b"r", i + 1)
         for i in range(n_views - 1)],
        dtype=[("scene", "S32"), ("seq", "i4"), ("cam1", "S1"),
               ("im1", "i4"), ("cam2", "S1"), ("im2", "i4")])
    np.save(root / "staticthings_pairs.npy", pairs)
    return root


def write_synthetic_habitat(root, size=1000, split="train", n_scenes=2,
                            h=24, w=32, focal=24.0, seed=0):
    root = Path(root)
    scenes = []
    for s in range(n_scenes):
        key = f"hab{s:03d}"
        scene_rel = osp.join("renders", key)
        scenes.append(scene_rel)
        data_path = root / "renders"
        views = _synth_views(5, h, w, focal, seed + s)
        for v, view in enumerate(views):
            _save_jpg(data_path / f"{key}_{v + 1}.jpeg", view["img"])
            write_exr(data_path / f"{key}_{v + 1}_depth.exr",
                      view["depth"], half=True)
            with open(data_path / f"{key}_{v + 1}_camera_params.json",
                      "w") as f:
                json.dump(dict(
                    camera_intrinsics=view["K"].tolist(),
                    R_cam2world=view["c2w"][:3, :3].tolist(),
                    t_cam2world=view["c2w"][:3, 3].tolist()), f)
    with open(root / f"Habitat_{size}_scenes_{split}.txt", "w") as f:
        f.write("\n".join(scenes))
    return root
