"""Quaternion, pose and sim(3) math (port of instantsplat_tpu/utils/transforms.py).

Conventions: quaternions are [w, x, y, z]; a pose is the world-to-camera
vector [qw qx qy qz tx ty tz].
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] to unit norm (grad-safe near 0)."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) [..., 4] (wxyz) -> rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _bottom_row(like: torch.Tensor) -> torch.Tensor:
    """[0, 0, 0, 1] in like's dtype, made on its device (no host copy, so
    it can be captured in a CUDA graph)."""
    row = like.new_zeros(4)
    row[3] = 1.0
    return row


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose vector(s) [..., 7] -> 4x4 world-to-camera matrices."""
    R = quat_to_rotmat(pose[..., :4])
    top = torch.cat([R, pose[..., 4:7, None]], dim=-1)
    bottom = _bottom_row(pose).expand(*pose.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def qvec_to_rotmat(q) -> np.ndarray:
    """wxyz quaternion -> rotation matrix (COLMAP convention), float64."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat_to_qvec(R) -> np.ndarray:
    """Rotation matrix -> wxyz quaternion with w >= 0 (COLMAP's
    eigen-decomposition construction)."""
    R = np.asarray(R, np.float64)
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    q = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return q if q[0] >= 0 else -q


def pose_to_matrix_np(pose) -> np.ndarray:
    """Numpy pose vector(s) [..., 7] -> float32 [..., 4, 4] w2c."""
    pose = np.asarray(pose, np.float64)
    batch = pose.shape[:-1]
    flat = pose.reshape(-1, 7)
    out = np.tile(np.eye(4, dtype=np.float32), (flat.shape[0], 1, 1))
    for k in range(flat.shape[0]):
        q = flat[k, :4]
        out[k, :3, :3] = qvec_to_rotmat(q / np.linalg.norm(q))
        out[k, :3, 3] = flat[k, 4:7]
    return out.reshape(*batch, 4, 4)


def matrix_to_pose_np(M) -> np.ndarray:
    """Numpy [..., 4, 4] w2c -> float32 pose vectors [..., 7] (w >= 0)."""
    M = np.asarray(M, np.float64)
    batch = M.shape[:-2]
    flat = M.reshape(-1, 4, 4)
    out = np.empty((flat.shape[0], 7), np.float32)
    for k in range(flat.shape[0]):
        out[k, :4] = rotmat_to_qvec(flat[k, :3, :3])
        out[k, 4:7] = flat[k, :3, 3]
    return out.reshape(*batch, 7)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (wxyz, w >= 0),
    branch-free: one candidate per largest diagonal term, picked by argmax."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    def _sqrtp(x):  # sqrt(max(0, x)) with a zero subgradient at 0
        return torch.sqrt(torch.clamp(x, min=0.0) + _EPS) - _EPS ** 0.5

    q_abs = torch.stack([_sqrtp(1.0 + m00 + m11 + m22),
                         _sqrtp(1.0 + m00 - m11 - m22),
                         _sqrtp(1.0 - m00 + m11 - m22),
                         _sqrtp(1.0 - m00 - m11 + m22)], dim=-1)
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    cands = cands / (2.0 * torch.clamp(q_abs, min=0.1))[..., None]
    best = torch.argmax(q_abs, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


def matrix_to_pose(M: torch.Tensor) -> torch.Tensor:
    """World-to-camera matrices [..., 4, 4] -> pose vectors [..., 7]
    (quaternion with w >= 0, then translation); differentiable."""
    return torch.cat([rotmat_to_quat(M[..., :3, :3]), M[..., :3, 3]], dim=-1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions [..., 4]."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], dim=-1)


def se3_inverse(M: torch.Tensor) -> torch.Tensor:
    """Invert rigid transform(s) [..., 4, 4] without a general solve."""
    Rt = M[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, M[..., :3, 3])
    top = torch.cat([Rt, t_inv[..., :, None]], dim=-1)
    bottom = _bottom_row(M).expand(*M.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def transform_points(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform(s) to points [..., N, 3]."""
    return (torch.einsum("...ij,...nj->...ni", M[..., :3, :3], pts)
            + M[..., None, :3, 3])


def _sim3_from_svd(U, D, Vt, var_s, mu_s, mu_d, with_scale):
    S = torch.eye(3, dtype=U.dtype, device=U.device)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S[2, 2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ S @ Vt
    s = (torch.trace(torch.diag(D) @ S) / torch.clamp(var_s, min=_EPS)
         if with_scale else torch.ones((), dtype=U.dtype, device=U.device))
    return s, R, mu_d - s * R @ mu_s


def umeyama(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = True):
    """Closed-form sim(3) (Umeyama 1991): (s, R, t) with
    dst ~= s * R @ src + t for [N, 3] point sets; reflection-safe."""
    mu_s = torch.mean(src, dim=0)
    mu_d = torch.mean(dst, dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    U, D, Vt = torch.linalg.svd(xd.T @ xs / src.shape[0])
    var_s = torch.mean(torch.sum(xs * xs, dim=-1))
    return _sim3_from_svd(U, D, Vt, var_s, mu_s, mu_d, with_scale)


def weighted_umeyama(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                     with_scale: bool = True):
    """`umeyama` with weights w [N] >= 0."""
    wn = (w / torch.clamp(torch.sum(w), min=_EPS))[:, None]
    mu_s = torch.sum(wn * src, dim=0)
    mu_d = torch.sum(wn * dst, dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    U, D, Vt = torch.linalg.svd((xd * wn).T @ xs)
    var_s = torch.sum(wn[:, 0] * torch.sum(xs * xs, dim=-1))
    return _sim3_from_svd(U, D, Vt, var_s, mu_s, mu_d, with_scale)
