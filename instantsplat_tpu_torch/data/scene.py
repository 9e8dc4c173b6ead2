"""Scene reading for stages 2-5 (port of instantsplat_tpu/data/scene.py:
`split_train_test`, `read_scene`, `read_colmap_gt_pose`, `save_time`).

Reads a split of the COLMAP-format scene that stage 1 writes
(`sparse_{n}/0` train, `sparse_{n}/1` test): text extrinsics and
intrinsics, cameras sorted by image name, ground-truth images resized to
the recorded resolution divided by `resolution_scale`, and the fused point
cloud, which is always `sparse_{n}/0/points3D.ply`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import colmap, images as image_io, ply
from instantsplat_tpu_torch.models.camera import Camera


def split_train_test(items, n_views):
    """The reference split: 12 linspace test indices over [1, len-2];
    train = n_views linspace over the remainder.

    Returns (train_items, test_items, train_idx, test_idx).
    """
    n = len(items)
    test_idx = np.linspace(1, n - 2, num=12, dtype=int)
    train_pool = [i for i in range(n) if i not in test_idx]
    sparse = np.linspace(0, len(train_pool) - 1, num=n_views, dtype=int)
    train_idx = [train_pool[i] for i in sparse]
    return ([items[i] for i in train_idx], [items[i] for i in test_idx],
            train_idx, list(test_idx))


@dataclasses.dataclass
class SceneInfo:
    cameras: list[Camera]  # with GT images attached, at model resolution
    poses_w2c: np.ndarray  # [V, 4, 4]
    points: np.ndarray  # [N, 3]
    colors: np.ndarray  # [N, 3] in [0, 1]
    nerf_radius: float  # cameras_extent (getNerfppNorm radius)
    image_names: list[str]
    ply_path: str


def _nerfpp_radius(w2c_list):
    """1.1 * the largest distance of a camera centre from their mean."""
    if not len(w2c_list):
        return 1.0
    centers = np.stack(
        [np.linalg.inv(np.asarray(m))[:3, 3] for m in w2c_list])
    d = np.linalg.norm(centers - centers.mean(0, keepdims=True), axis=-1)
    return float(d.max() * 1.1)


def save_time(time_dir, process_name, seconds):
    """Append '<name>: M min S sec' to train_time.txt."""
    time_dir = Path(time_dir)
    time_dir.mkdir(parents=True, exist_ok=True)
    minutes, secs = divmod(seconds, 60)
    with open(time_dir / "train_time.txt", "a") as f:
        f.write(f"{process_name}: {int(minutes)} min {int(secs)} sec\n")


def read_scene(source_path, n_views, split="train", images_dir="images",
               resolution_scale=1.0, load_images=True,
               device="cuda") -> SceneInfo:
    """The train (sparse_{n_views}/0) or test (sparse_{n_views}/1) split;
    without `load_images` the cameras carry no image."""
    source_path = Path(source_path)
    sparse = source_path / f"sparse_{n_views}" / ("0" if split == "train"
                                                  else "1")
    extr = colmap.read_images_text(sparse / "images.txt")
    intr = colmap.read_cameras_text(sparse / "cameras.txt")

    items = sorted(extr.values(), key=lambda im: im.name)
    cams, poses, names = [], [], []
    for uid, im in enumerate(items):
        cam_int = intr[im.camera_id]
        fx, fy = cam_int.params[0], cam_int.params[1]
        w, h = cam_int.width, cam_int.height
        scale = resolution_scale
        rw, rh = round(w / scale), round(h / scale)
        img = None
        img_path = source_path / images_dir / im.name
        if load_images and img_path.exists():
            img = image_io.load_image(img_path)
            if img.shape[:2] != (rh, rw):
                img = image_io.pil_resize(img, (rw, rh))
        w2c = im.w2c
        cams.append(Camera.create(
            R=w2c[:3, :3], t=w2c[:3, 3],
            fx=fx / scale * (rw / (w / scale)),
            fy=fy / scale * (rh / (h / scale)),
            height=rh, width=rw, image=img, uid=uid, device=device))
        poses.append(w2c)
        names.append(im.name)

    ply_path = source_path / f"sparse_{n_views}" / "0" / "points3D.ply"
    if ply_path.exists():
        pts, cols = ply.fetch_point_cloud(ply_path)
    else:
        pts = np.zeros((0, 3), np.float32)
        cols = np.zeros((0, 3), np.float32)
    return SceneInfo(
        cameras=cams,
        poses_w2c=np.stack(poses) if poses else np.zeros((0, 4, 4)),
        points=pts,
        colors=cols,
        nerf_radius=_nerfpp_radius(poses),
        image_names=names,
        ply_path=str(ply_path),
    )


def read_colmap_gt_pose(gt_pose_path, sparse_dir="sparse/0") -> np.ndarray:
    """Ground-truth c2w [V, 4, 4] from the dataset's own COLMAP model,
    sorted by image name (for the metrics stage)."""
    extr = colmap.read_images_text(Path(gt_pose_path) / sparse_dir
                                   / "images.txt")
    items = sorted(extr.values(), key=lambda im: im.name)
    return np.stack([np.linalg.inv(im.w2c) for im in items])
