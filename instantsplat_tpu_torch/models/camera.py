"""Pinhole camera (port of instantsplat_tpu/models/camera.py).

Intrinsics are 0-dim float32 tensors, as the JAX Camera holds float32
scalars, so every derived quantity (tan(fov/2), the Jacobian) is computed
in float32 in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.utils import transforms as T


@dataclasses.dataclass
class Camera:
    """One pinhole camera.

    pose: [7] = [qw qx qy qz tx ty tz], world-to-camera.
    fx, fy, cx, cy: 0-dim float32 tensors, in pixels.
    image: optional [H, W, 3] ground truth in [0, 1].
    uid: index of the camera's learnable pose in GaussianModel.cam_poses.
    """

    pose: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    image: Optional[torch.Tensor] = None
    uid: int = 0
    height: int = 0
    width: int = 0

    @classmethod
    def create(cls, R, t, fx: float, fy: float, height: int, width: int,
               image: Optional[np.ndarray] = None, cx: Optional[float] = None,
               cy: Optional[float] = None, uid: int = 0,
               device="cuda") -> "Camera":
        """Build from world-to-camera rotation R [3,3] and translation t [3]."""
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = np.asarray(R, np.float32)
        M[:3, 3] = np.asarray(t, np.float32)

        def f32(v):
            return torch.tensor(np.float32(v), device=device)

        return cls(
            pose=torch.as_tensor(T.matrix_to_pose_np(M), device=device),
            fx=f32(fx),
            fy=f32(fy),
            # the reference CUDA ndc2Pix convention: (W-1)/2, not COLMAP's W/2
            cx=f32((width - 1) / 2 if cx is None else cx),
            cy=f32((height - 1) / 2 if cy is None else cy),
            image=(None if image is None else
                   torch.as_tensor(np.asarray(image, np.float32),
                                   device=device)),
            uid=int(uid),
            height=int(height),
            width=int(width),
        )
