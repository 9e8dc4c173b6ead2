"""Scene I/O (port of instantsplat_tpu/data/scene.py).

Stage 1 writes a COLMAP-format scene (`sparse_{n}/0` train, `sparse_{n}/1`
test) plus ply/npy sidecars; stages 2-5 read a split of it back: text
extrinsics and intrinsics, cameras sorted by image name, ground-truth
images resized to the recorded resolution divided by `resolution_scale`,
and the fused point cloud, which is always `sparse_{n}/0/points3D.ply`.
The Blender / NeRF-synthetic reader (`read_nerf_synthetic`) reads
`transforms_{train,test}.json` scenes; their RGBA PNGs go through the
package's own codec (data/png.py), so they need no Pillow.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import colmap, images as image_io, ply, png
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


def init_filestructure(save_path, n_views):
    """Create <save_path>/sparse_{n}/0 and /1 (sfm_utils.py:107-120)."""
    save_path = Path(save_path)
    tag = f"sparse_{n_views}" if n_views else "sparse_0"
    sparse_0 = save_path / tag / "0"
    sparse_1 = save_path / tag / "1"
    sparse_0.mkdir(parents=True, exist_ok=True)
    sparse_1.mkdir(parents=True, exist_ok=True)
    return save_path, sparse_0, sparse_1


# ---------------------------------------------------------------------------
# stage-1 writers (init_geo artifacts)
# ---------------------------------------------------------------------------


def save_extrinsics(sparse_path, w2c_list, img_files, image_suffix):
    """images.{bin,txt} from [V,4,4] w2c matrices (sfm_utils.py:202-228)."""
    sparse_path = Path(sparse_path)
    ims = {}
    for i, (w2c, img_file) in enumerate(zip(w2c_list, img_files), start=1):
        w2c = np.asarray(w2c)
        ims[i] = colmap.ColmapImage(
            id=i,
            qvec=colmap.rotmat_to_qvec(w2c[:3, :3]),
            tvec=np.asarray(w2c[:3, 3]),
            camera_id=i,
            name=Path(img_file).stem + image_suffix,
        )
    colmap.write_images_binary(ims, sparse_path / "images.bin")
    colmap.write_images_text(ims, sparse_path / "images.txt")


def save_intrinsics(sparse_path, focals, org_wh, model_hw, save_focals=False):
    """cameras.{bin,txt}: PINHOLE at the ORIGINAL resolution with the model
    focal scaled up (sfm_utils.py:230-247).

    org_wh / model_hw: one (W, H) / (H, W) shared by all views, or lists
    with one entry per view (mixed-aspect scenes — each image gets its own
    camera record; extrinsics already write camera_id per image)."""
    sparse_path = Path(sparse_path)
    focals = np.asarray(focals).ravel()
    n = len(focals)
    org_whs = (list(org_wh) if isinstance(org_wh[0], (tuple, list,
                                                      np.ndarray))
               else [org_wh] * n)
    model_hws = (list(model_hw) if isinstance(model_hw[0], (tuple, list,
                                                            np.ndarray))
                 else [model_hw] * n)
    cams = {}
    for i, focal in enumerate(focals, start=1):
        org_w, org_h = org_whs[i - 1]
        h, w = model_hws[i - 1]
        sx, sy = org_w / w, org_h / h
        cams[i] = colmap.ColmapCamera(
            id=i, model="PINHOLE", width=int(org_w), height=int(org_h),
            params=np.array(
                [focal * sx, focal * sy, org_w / 2.0, org_h / 2.0]),
        )
    colmap.write_cameras_binary(cams, sparse_path / "cameras.bin")
    colmap.write_cameras_text(cams, sparse_path / "cameras.txt")
    if save_focals:
        np.save(sparse_path / "non_scaled_focals.npy", np.asarray(focals))


def save_points3d(
    sparse_path, imgs, pts3d, confs, masks=None, use_masks=True,
    save_all_pts=False, save_txt_path=None, depth_threshold=0.1,
    max_pts_num=int(150e10),
):
    """points3D.ply + confidence sidecars (sfm_utils.py:250-315).

    imgs: [V,H,W,3] in [0,1]; pts3d: [V,H,W,3] (or flattenable); confs:
    [V,H,W]; masks: [V,H,W] bool KEEP-mask (the reference passes ~co_vis).
    Returns the number of saved points.
    """
    sparse_path = Path(sparse_path)
    imgs = np.asarray(imgs)
    pts3d = np.asarray(pts3d).reshape(imgs.shape)
    confs = np.asarray(confs).reshape(imgs.shape[:-1])
    np.save(sparse_path / "confidence.npy", confs)

    if use_masks and masks is not None:
        masks = np.asarray(masks).astype(bool)
        pts = pts3d[masks].reshape(-1, 3)
        col = imgs[masks].reshape(-1, 3) * 255.0
        conf = confs[masks].reshape(-1, 1)
    else:
        pts = pts3d.reshape(-1, 3)
        col = imgs.reshape(-1, 3) * 255.0
        conf = confs.reshape(-1, 1)

    vanilla_num = pts3d.reshape(-1, 3).shape[0]
    co_mask_num = pts.shape[0]
    if pts.shape[0] > max_pts_num:
        # confidence-weighted downsample (sfm_utils.py:279-296)
        c = conf.ravel()
        c = (c - c.min()) / max(c.max() - c.min(), 1e-12) + 1.0
        w = c / c.sum()
        idx = np.random.choice(pts.shape[0], max_pts_num, replace=False, p=w)
        pts, col, conf = pts[idx], col[idx], conf[idx]
    np.save(sparse_path / "confidence_dsp.npy", conf)
    ply.store_point_cloud(sparse_path / "points3D.ply", pts, col)
    if save_all_pts:
        np.save(sparse_path / "points3D_all.npy", pts3d)
        np.save(sparse_path / "pointsColor_all.npy", imgs)

    if save_txt_path is not None:
        with open(Path(save_txt_path) / "pts_num.txt", "a") as f:
            f.write(f"Depth threshold: {depth_threshold}\n")
            f.write(f"Vanilla points num: {vanilla_num}\n")
            f.write(f"Co_Mask DSP points num: {co_mask_num}\n")
            f.write(f"Co_Mask DSP ratio: {co_mask_num / vanilla_num}\n\n")
    return pts.shape[0]


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


# ---------------------------------------------------------------------------
# Blender / NeRF-synthetic transforms reader
# (scene/dataset_readers.py:372-448)
# ---------------------------------------------------------------------------


def _read_rgba(path) -> np.ndarray:
    """-> uint8 [H, W, 4], as PIL's convert("RGBA") gives it: grey is
    replicated, a missing alpha is 255."""
    if Path(path).suffix.lower() != ".png":
        Image = image_io._pillow(f"reading {path}")
        return np.asarray(Image.open(path).convert("RGBA"))
    arr = png.read_png(path)
    c = arr.shape[2]
    rgb = arr[:, :, :3] if c >= 3 else np.repeat(arr[:, :, :1], 3, axis=2)
    alpha = (arr[:, :, c - 1:] if c in (2, 4)
             else np.full(arr.shape[:2] + (1,), 255, np.uint8))
    return np.concatenate([rgb, alpha], axis=2)


def read_cameras_from_transforms(path, transformsfile, white_background,
                                 extension=".png", device="cuda"):
    """-> (cameras, poses_w2c, names): NeRF transforms_*.json frames with
    the OpenGL->COLMAP axis flip and alpha compositing over the
    background; cameras (and their images) on `device`."""
    path = Path(path)
    with open(path / transformsfile) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cams, poses, names = [], [], []
    for idx, frame in enumerate(contents["frames"]):
        img_path = path / (frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        im = _read_rgba(img_path).astype(np.float32) / 255.0
        bg = np.ones(3) if white_background else np.zeros(3)
        rgb = im[:, :, :3] * im[:, :, 3:4] + bg * (1 - im[:, :, 3:4])
        h, w = rgb.shape[:2]
        fx = w / (2 * np.tan(fovx / 2))
        cams.append(Camera.create(
            R=w2c[:3, :3], t=w2c[:3, 3], fx=fx, fy=fx, height=h, width=w,
            image=rgb.astype(np.float32), uid=idx, device=device))
        poses.append(w2c)
        names.append(Path(frame["file_path"]).stem + extension)
    return cams, np.stack(poses), names


def read_nerf_synthetic(path, white_background=False, eval_split=True,
                        extension=".png", num_random_pts=100_000, seed=0,
                        device="cuda"):
    """readNerfSyntheticInfo: transforms_{train,test}.json and a random
    init point cloud, stored to points3d.ply on the first read
    -> (SceneInfo, test cameras, test poses)."""
    path = Path(path)
    train_cams, train_poses, names = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension, device)
    try:
        test_cams, test_poses, _ = read_cameras_from_transforms(
            path, "transforms_test.json", white_background, extension,
            device)
    except OSError:
        test_cams, test_poses = [], np.zeros((0, 4, 4))
    if not eval_split:
        train_cams = train_cams + test_cams
        train_poses = np.concatenate([train_poses, test_poses]) \
            if len(test_cams) else train_poses
        test_cams, test_poses = [], np.zeros((0, 4, 4))

    ply_path = path / "points3d.ply"
    if not ply_path.exists():
        rng = np.random.default_rng(seed)
        xyz = rng.random((num_random_pts, 3)) * 2.6 - 1.3
        # random SH DC -> RGB like the reference (SH2RGB(rand/255))
        c0 = 0.28209479177387814
        cols = (rng.random((num_random_pts, 3)) / 255.0) * c0 + 0.5
        ply.store_point_cloud(ply_path, xyz, cols * 255.0)
    pts, cols = ply.fetch_point_cloud(ply_path)
    return SceneInfo(
        cameras=train_cams,
        poses_w2c=train_poses,
        points=pts,
        colors=cols,
        nerf_radius=_nerfpp_radius(list(train_poses)),
        image_names=names,
        ply_path=str(ply_path),
    ), test_cams, test_poses
