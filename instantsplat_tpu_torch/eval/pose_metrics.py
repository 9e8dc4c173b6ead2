"""Camera-trajectory evaluation: Procrustes scale align, sim3 (Umeyama)
trajectory alignment, ATE RMSE, RPE (a copy of
instantsplat_tpu/eval/pose_metrics.py; numpy and scipy, float64).

Clean-room equivalents of the reference's pose-metric toolkit as driven by
metrics.py:90-118:

1. `align_pose` (utils/sfm_utils.py:464-493): zero-center both camera-center
   sets, scale each to unit Frobenius norm, then scale the estimate by the
   Procrustes optimal scale (orthogonal_procrustes);
2. `align_ate_c2b_use_a2b` (utils/utils_poses/align_traj.py:34-77 with
   method='sim3'): Umeyama on camera centers, gt ~= s R est + t, applied to
   the estimated c2w trajectory (rotations rotated by R, centers mapped by
   s R + t);
3. `compute_ate` (utils/utils_poses/comp_ate.py:59-80): RMSE over camera-
   center distances; `compute_rpe` (comp_ate.py:40-57): mean relative-pose
   translation/rotation errors over consecutive frames.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def align_pose(t_gt, t_est):
    """Procrustes scale alignment of two [N,3] camera-center sets.

    Returns (t_gt_aligned, t_est_aligned): both zero-centered and
    unit-normalized, with the estimate multiplied by the optimal scale.
    """
    a = np.array(t_gt, np.float64, copy=True)
    b = np.array(t_est, np.float64, copy=True)
    a -= a.mean(0)
    b -= b.mean(0)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        raise ValueError("degenerate trajectories")
    a /= na
    b /= nb
    _, s = scipy.linalg.orthogonal_procrustes(a, b)
    return a, b * s


def umeyama(model, data, known_scale=False):
    """model ~= s * R @ data + t (Umeyama 1991; ATE/align_trajectory.py)."""
    model = np.asarray(model, np.float64)
    data = np.asarray(data, np.float64)
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    mc = model - mu_m
    dc = data - mu_d
    n = len(model)
    C = (mc.T @ dc) / n
    sigma2 = float((dc * dc).sum()) / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt.T) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0 if known_scale else float(np.trace(np.diag(D) @ S) / sigma2)
    t = mu_m - s * (R @ mu_d)
    return s, R, t


def align_ate_c2b_use_a2b(traj_a, traj_b, traj_c=None):
    """sim3-align trajectory c (default: a) onto b using the a->b fit.

    traj_*: [N, 4, 4] c2w matrices. Returns aligned [N, 4, 4].
    """
    traj_a = np.asarray(traj_a, np.float64)
    traj_b = np.asarray(traj_b, np.float64)
    if traj_c is None:
        traj_c = traj_a.copy()
    traj_c = np.asarray(traj_c, np.float64)

    s, R, t = umeyama(traj_b[:, :3, 3], traj_a[:, :3, 3])
    out = np.tile(np.eye(4), (len(traj_c), 1, 1))
    out[:, :3, :3] = R[None] @ traj_c[:, :3, :3]
    out[:, :3, 3] = (s * (R @ traj_c[:, :3, 3:4]))[..., 0] + t
    return out


def rotation_error(rel):
    d = 0.5 * (rel[0, 0] + rel[1, 1] + rel[2, 2] - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def compute_ate(gt, pred):
    """RMSE of camera-center distances, [N,4,4] each."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    err = np.linalg.norm(gt[:, :3, 3] - pred[:, :3, 3], axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def compute_rpe(gt, pred):
    """Mean consecutive relative-pose (translation, rotation) errors."""
    gt = np.asarray(gt)
    pred = np.asarray(pred)
    t_errs, r_errs = [], []
    for i in range(len(gt) - 1):
        gt_rel = np.linalg.inv(gt[i]) @ gt[i + 1]
        pr_rel = np.linalg.inv(pred[i]) @ pred[i + 1]
        rel = np.linalg.inv(gt_rel) @ pr_rel
        t_errs.append(float(np.linalg.norm(rel[:3, 3])))
        r_errs.append(rotation_error(rel))
    return float(np.mean(t_errs)), float(np.mean(r_errs))


def evaluate_pose(pose_est_c2w, pose_gt_c2w):
    """Full reference pose-eval flow (metrics.py:98-118): Procrustes scale
    align on centers, sim3 ATE alignment, then ATE/RPE.

    Returns dict with RPE_t (x100), RPE_r (degrees), ATE — the exact
    scaling/units written to results.json.
    """
    est = np.array(pose_est_c2w, np.float64, copy=True)
    gt = np.array(pose_gt_c2w, np.float64, copy=True)
    gt_centers, est_centers = align_pose(gt[:, :3, 3], est[:, :3, 3])
    gt[:, :3, 3] = gt_centers
    est[:, :3, 3] = est_centers
    est_aligned = align_ate_c2b_use_a2b(est, gt)
    ate = compute_ate(gt, est_aligned)
    rpe_t, rpe_r = compute_rpe(gt, est_aligned)
    return {
        "RPE_t": rpe_t * 100.0,
        "RPE_r": rpe_r * 180.0 / np.pi,
        "ATE": ate,
    }
