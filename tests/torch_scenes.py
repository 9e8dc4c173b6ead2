"""Tiny COLMAP-format scenes for the port's tests, written with the port's
own writers (no JAX), so that the tests that need a card can use them too.

- `write_tiny_scene`: sparse_3/0 (three train views, 64x48 PNGs, 500
  points);
- `write_test_split`: sparse_3/1, test views between the train views with
  start poses perturbed from their look-at poses;
- `write_gt_model`: the dataset's ground truth sparse/0/images.txt, 15
  views whose split_train_test(., 3) train subset is the three train
  views (indices 0, 12 and 14);
- `refine_case`: Gaussians, a view and a perturbed start pose for the
  test-time pose refiner;
- `send_view_request` / `receive_image`: a SIBR viewer client's side of
  render/network_gui.py's protocol.
"""

import json
from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch.data import colmap, png, ply
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.render.driver import render
from instantsplat_tpu_torch.utils import transforms as T

H, W, N_PTS = 48, 64, 500
TRAIN_ANGLES = (-0.2, 0.0, 0.2)
TEST_ANGLES = (-0.1, 0.1)


def look_at(eye):
    fwd = -np.asarray(eye, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    M = np.eye(4)
    M[:3, :3], M[:3, 3] = R, -R @ np.asarray(eye)
    return M


def _camera(cid, h, w):
    f = 60.0 * w / W
    return colmap.ColmapCamera(cid, "PINHOLE", w, h,
                               np.array([f, f, w / 2, h / 2]))


def write_tiny_scene(root: Path, seed=0, n_pts=N_PTS, hw=(H, W)):
    """sparse_3/0 (COLMAP text + points3D.ply of `n_pts` points) and
    images/*.png of `hw` pixels (the focal scales with the width)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    sparse = root / "sparse_3" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    pts = rng.normal(size=(n_pts, 3)) * [0.8, 0.6, 0.4]
    # no color at exactly 0: there SH + 0.5 sits on the max(., 0) clamp,
    # where jitted JAX (an FMA leaves it at -eps) and eager PyTorch take
    # different subgradients (ROADMAP.md queue 3)
    ply.store_point_cloud(sparse / "points3D.ply", pts,
                          rng.uniform(1, 255, (n_pts, 3)))
    yy, xx = np.mgrid[0:h, 0:w] / 10.0
    cams, ims = {}, {}
    for i, ang in enumerate(TRAIN_ANGLES):
        img = np.stack([np.sin(xx + i), np.cos(yy - i), np.sin(xx * yy)], -1)
        png.write_png(root / "images" / f"{i:03d}.png",
                      ((img * 0.4 + 0.5) * 255).astype(np.uint8))
        w2c = look_at((4 * np.sin(ang), 0.2, -4 * np.cos(ang)))
        cams[i + 1] = _camera(i + 1, h, w)
        ims[i + 1] = colmap.ColmapImage(i + 1, T.rotmat_to_qvec(w2c[:3, :3]),
                                        w2c[:3, 3], i + 1, f"{i:03d}.png")
    colmap.write_cameras_text(cams, sparse / "cameras.txt")
    colmap.write_images_text(ims, sparse / "images.txt")


def write_test_split(root: Path, angles=TEST_ANGLES, hw=(H, W)):
    """sparse_3/1 with test views between the train views: images, and
    start poses perturbed from their look-at poses."""
    sparse = root / "sparse_3" / "1"
    sparse.mkdir(parents=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / 10.0
    cams, ims = {}, {}
    rng = np.random.default_rng(9)
    for i, ang in enumerate(angles):
        name = f"t{i:02d}.png"
        img = np.stack([np.sin(xx + ang), np.cos(yy - ang),
                        np.sin(xx * yy + ang)], -1)
        png.write_png(root / "images" / name,
                      ((img * 0.4 + 0.5) * 255).astype(np.uint8))
        w2c = look_at((4 * np.sin(ang), 0.2, -4 * np.cos(ang)))
        w2c[:3, 3] += rng.normal(size=3) * 0.05
        cams[i + 1] = _camera(i + 1, h, w)
        ims[i + 1] = colmap.ColmapImage(i + 1, T.rotmat_to_qvec(w2c[:3, :3]),
                                        w2c[:3, 3], i + 1, name)
    colmap.write_cameras_text(cams, sparse / "cameras.txt")
    colmap.write_images_text(ims, sparse / "images.txt")


def write_gt_model(root: Path):
    """sparse/0/images.txt of 15 views on the arc; split_train_test(., 3)
    picks indices 0, 12 and 14, placed at the train views' poses."""
    angles = np.linspace(-0.2, 0.0, 13).tolist() + [0.1, 0.2]
    ims = {}
    for k, ang in enumerate(angles):
        w2c = look_at((4 * np.sin(ang), 0.2, -4 * np.cos(ang)))
        ims[k + 1] = colmap.ColmapImage(k + 1, T.rotmat_to_qvec(w2c[:3, :3]),
                                        w2c[:3, 3], 1, f"gt_{k:02d}.png")
    (root / "sparse" / "0").mkdir(parents=True)
    colmap.write_images_text(ims, root / "sparse" / "0" / "images.txt")


def write_eval_scene(root: Path, n_pts=N_PTS, hw=(H, W)):
    """A tiny scene with a test split and a ground-truth model."""
    write_tiny_scene(root, n_pts=n_pts, hw=hw)
    write_test_split(root, hw=hw)
    write_gt_model(root)


def refine_case():
    """Seeded non-degenerate Gaussians, a camera whose ground truth is the
    render at its own pose, and a start perturbed from that pose by 0.03
    rad and a few hundredths of the distance."""
    rng = np.random.default_rng(8)
    n = 500
    g = GaussianModel.create_from_pcd(
        rng.normal(size=(n, 3)) * [1.0, 0.8, 0.3],
        rng.uniform(0.05, 0.95, (n, 3)), cam_poses=np.zeros((1, 7)),
        max_sh_degree=1, device="cpu")
    arrays = {f: getattr(g, f).numpy() for f in PARAM_FIELDS}
    arrays["scaling"] = arrays["scaling"] + rng.normal(size=(n, 3)) * 0.3
    arrays["opacity"] = rng.normal(size=(n, 1)) + 1.0
    arrays["rotation"] = rng.normal(size=(n, 4))
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    M = look_at((0.5, 0.3, -4.0))
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    with torch.no_grad():
        gt = render(g, Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0,
                                     height=H, width=W, device="cpu"),
                    backend="oracle").render.numpy()
    c, s = np.cos(0.03), np.sin(0.03)
    P = M.copy()
    P[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ M[:3, :3]
    P[:3, 3] += [0.05, -0.04, 0.03]
    return arrays, M, gt, T.matrix_to_pose_np(P)


def send_view_request(conn, h, w, w2c=None):
    """One SIBR request for an h x w view of the world-to-camera `w2c`
    (identity by default): the viewer sends its view matrix transposed,
    with the y and z columns negated, fov_x 1.0 and fov_y 0.8."""
    view = np.eye(4) if w2c is None else np.array(w2c, np.float64).T
    view[:, 1:3] *= -1
    msg = dict(resolution_x=w, resolution_y=h, train=False, fov_y=0.8,
               fov_x=1.0, z_near=0.01, z_far=100.0, shs_python=False,
               rot_scale_python=False, keep_alive=True, scaling_modifier=1.0,
               view_matrix=view.flatten().tolist(),
               view_projection_matrix=view.flatten().tolist())
    payload = json.dumps(msg).encode("utf-8")
    conn.sendall(len(payload).to_bytes(4, "little") + payload)


def receive_image(conn, h, w):
    """-> (the [h, w, 3] uint8 image, the verification string)."""
    img = b""
    while len(img) < h * w * 3:
        chunk = conn.recv(h * w * 3 - len(img))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        img += chunk
    n = int.from_bytes(conn.recv(4), "little")
    return (np.frombuffer(img, np.uint8).reshape(h, w, 3),
            conn.recv(n).decode("ascii"))
