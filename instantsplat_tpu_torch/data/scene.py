"""Scene reading for stage 2 (port of instantsplat_tpu/data/scene.py:
`read_scene`, `save_time`).

Reads the training split `sparse_{n}/0` of the COLMAP-format scene that
stage 1 writes: text extrinsics and intrinsics, cameras sorted by image
name, ground-truth images resized to the recorded resolution divided by
`resolution_scale`, and the fused point cloud `sparse_{n}/0/points3D.ply`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import colmap, images as image_io, ply
from instantsplat_tpu_torch.models.camera import Camera


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


def read_scene(source_path, n_views, images_dir="images",
               resolution_scale=1.0, device="cuda") -> SceneInfo:
    """The training split, sparse_{n_views}/0."""
    source_path = Path(source_path)
    sparse = source_path / f"sparse_{n_views}" / "0"
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
        if img_path.exists():
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

    ply_path = sparse / "points3D.ply"
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
