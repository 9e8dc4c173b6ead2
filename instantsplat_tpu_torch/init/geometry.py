"""Geometry primitives for global alignment: sim3 registration, focal
estimation, pointmap transforms (port of instantsplat_tpu/init/geometry.py).

Numpy/PyTorch clean-room equivalents of the routines the reference pulls from
the `roma` library and dust3r utils:

- `rigid_points_registration`: weighted Umeyama (Kabsch + scale), the
  behavioral contract of roma.rigid_points_registration(compute_scaling=True)
  as used at dust3r/cloud_opt/init_im_poses.py:233-236 and
  utils/sfm_utils.py:101-104: returns (s, R, T) with y ~= s * R @ x + T;
- `estimate_focal_weiszfeld`: dust3r/post_process.py:12-60 ('weiszfeld'
  mode): closed-form least-squares init + 10 IRLS iterations, clipped to
  [0.5, 3.5] x focal_base;
- `signed_log1p` / `signed_expm1`: dust3r/cloud_opt/commons.py:71-79 —
  the translation reparameterization of the alignment poses;
- `geotrf`: homogeneous transform of [..., 3] point arrays
  (dust3r/utils/geometry.py:40-101, the subset the aligner uses).
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(x):
    return torch if torch.is_tensor(x) else np


def signed_log1p(x):
    xp = _xp(x)
    return xp.sign(x) * xp.log1p(xp.abs(x))


def signed_expm1(x):
    xp = _xp(x)
    return xp.sign(x) * xp.expm1(xp.abs(x))


def geotrf(trf, pts):
    """Apply [...,4,4] (or [4,4]) homogeneous transform to [..., N, 3] pts
    (numpy arrays or tensors)."""
    R = trf[..., :3, :3]
    t = trf[..., :3, 3]
    return pts @ R.swapaxes(-1, -2) + t[..., None, :]


def sRT_to_4x4(s, R, T):
    """[[s*R, T], [0, 1]] (dust3r/cloud_opt/init_im_poses.py:239-243)."""
    trf = np.eye(4)
    trf[:3, :3] = np.asarray(R) * s
    trf[:3, 3] = np.asarray(T).ravel()
    return trf


def rigid_points_registration(pts1, pts2, conf=None):
    """Weighted sim3: find (s, R, T) minimizing sum w |s R x + T - y|^2.

    pts1/pts2: [..., 3] (flattened internally); conf: optional weights.
    Umeyama with weights; reflection-safe via det correction.
    """
    x = np.asarray(pts1, np.float64).reshape(-1, 3)
    y = np.asarray(pts2, np.float64).reshape(-1, 3)
    if conf is None:
        w = np.ones(len(x))
    else:
        w = np.asarray(conf, np.float64).ravel()
    w = w / max(w.sum(), 1e-12)

    mu_x = w @ x
    mu_y = w @ y
    xc = x - mu_x
    yc = y - mu_y
    cov = (yc * w[:, None]).T @ xc  # [3,3] = sum w y x^T
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    var_x = float(np.sum(w[:, None] * xc * xc))
    s = float(np.trace(np.diag(S) @ D) / max(var_x, 1e-18))
    T = mu_y - s * (R @ mu_x)
    return s, R, T


def align_multiple_poses(src_poses, target_poses):
    """sim3 aligning one pose set onto another, matching
    init_im_poses.py:313-321: registers camera centers plus points nudged
    along each camera's +z by eps = median-inter-camera-distance / 100."""
    src = np.asarray(src_poses, np.float64)
    tgt = np.asarray(target_poses, np.float64)

    def center_and_z(poses):
        c = poses[:, :3, 3]
        d = np.linalg.norm(c[:, None] - c[None], axis=-1)
        iu = np.triu_indices(len(c), 1)
        eps = (np.median(d[iu]) if len(iu[0]) else 1.0) / 100.0
        return np.concatenate([c, c + eps * poses[:, :3, 2]])

    return rigid_points_registration(center_and_z(src), center_and_z(tgt))


def estimate_focal_median(pts3d, pp=None, min_focal=0.5, max_focal=3.5):
    """'median' focal mode (dust3r/post_process.py:22-30): nanmedian of the
    per-pixel votes u*z/x and v*z/y."""
    pts = np.asarray(pts3d, np.float64)
    H, W, _ = pts.shape
    if pp is None:
        pp = np.array([W / 2.0, H / 2.0])
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    u = (gx - pp[0]).ravel()
    v = (gy - pp[1]).ravel()
    p = pts.reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        fx_votes = u * p[:, 2] / p[:, 0]
        fy_votes = v * p[:, 2] / p[:, 1]
    focal = np.nanmedian(np.concatenate([fx_votes, fy_votes]))
    focal_base = max(H, W) / (2 * np.tan(np.deg2rad(60) / 2))
    return float(np.clip(focal, min_focal * focal_base,
                         max_focal * focal_base))


def estimate_focal_weiszfeld(pts3d, pp=None, min_focal=0.5, max_focal=3.5):
    """Estimate focal from a camera-frame pointmap [H, W, 3].

    Weiszfeld IRLS on |pixel - f * (x,y)/z| (dust3r/post_process.py:33-56),
    focal clipped to [min,max] * (max(H,W) / (2 tan 30deg)).
    """
    pts = np.asarray(pts3d, np.float64)
    H, W, _ = pts.shape
    if pp is None:
        pp = np.array([W / 2.0, H / 2.0])
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    pixels = np.stack([gx, gy], -1).reshape(-1, 2) - pp
    p = pts.reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        xy_over_z = p[:, :2] / p[:, 2:3]
    xy_over_z = np.nan_to_num(xy_over_z, posinf=0, neginf=0)

    dot_xy_px = np.sum(xy_over_z * pixels, -1)
    dot_xy_xy = np.sum(xy_over_z**2, -1)
    focal = dot_xy_px.mean() / max(dot_xy_xy.mean(), 1e-18)
    for _ in range(10):
        dis = np.linalg.norm(pixels - focal * xy_over_z, axis=-1)
        w = 1.0 / np.clip(dis, 1e-8, None)
        focal = (w * dot_xy_px).mean() / max((w * dot_xy_xy).mean(), 1e-18)

    focal_base = max(H, W) / (2 * np.tan(np.deg2rad(60) / 2))
    return float(np.clip(focal, min_focal * focal_base, max_focal * focal_base))
