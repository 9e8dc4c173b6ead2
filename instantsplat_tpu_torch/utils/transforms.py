"""Quaternion and pose conversions (port of instantsplat_tpu/utils/transforms.py,
the parts stage 2 uses).

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


def pose_to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose vector(s) [..., 7] -> 4x4 world-to-camera matrices."""
    R = quat_to_rotmat(pose[..., :4])
    top = torch.cat([R, pose[..., 4:7, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose.dtype,
                          device=pose.device).expand(*pose.shape[:-1], 1, 4)
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
