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


def fov2focal(fov, pixels):
    return pixels / (2 * np.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * np.arctan(pixels / (2 * focal))


@dataclasses.dataclass
class Camera:
    """One pinhole camera.

    pose: [7] = [qw qx qy qz tx ty tz], world-to-camera.
    fx, fy, cx, cy: 0-dim float32 tensors, in pixels.
    image: optional [H, W, 3] ground truth in [0, 1].
    uid: index of the camera's learnable pose in GaussianModel.cam_poses.
    znear, zfar: the reference's clip planes (get_projection_matrix).
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
    znear: float = 0.01
    zfar: float = 100.0

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

    @property
    def w2c(self) -> torch.Tensor:
        return T.pose_to_matrix(self.pose)

    @property
    def c2w(self) -> torch.Tensor:
        return T.se3_inverse(self.w2c)

    @property
    def center(self) -> torch.Tensor:
        """Camera centre in world coordinates."""
        return self.c2w[..., :3, 3]

    @property
    def fovx(self) -> torch.Tensor:
        return 2 * torch.arctan(self.width / (2 * self.fx))

    @property
    def fovy(self) -> torch.Tensor:
        return 2 * torch.arctan(self.height / (2 * self.fy))

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)


def stack_cameras(cams: list[Camera]) -> Camera:
    """Same-resolution cameras -> one Camera of [V, ...] tensors (uid an
    int64 [V] tensor); height, width, znear and zfar stay scalars."""
    assert len({(c.height, c.width) for c in cams}) == 1, \
        "resolutions must match"
    c0 = cams[0]
    images = [c.image for c in cams]
    return dataclasses.replace(
        c0,
        pose=torch.stack([c.pose for c in cams]),
        fx=torch.stack([c.fx for c in cams]),
        fy=torch.stack([c.fy for c in cams]),
        cx=torch.stack([c.cx for c in cams]),
        cy=torch.stack([c.cy for c in cams]),
        image=None if images[0] is None else torch.stack(images),
        uid=torch.tensor([int(c.uid) for c in cams], dtype=torch.int64,
                         device=c0.pose.device),
    )


def gather_camera(stacked: Camera, idx: torch.Tensor) -> Camera:
    """View `idx` ([1] int64 device tensor) of `stack_cameras`' output as
    a Camera (uid a [1] tensor): device gathers only, so a captured graph
    picks the view its replay is given (JAX gathers c[view_idx] inside its
    scan)."""

    def pick(t):
        return t.index_select(0, idx)[0]

    return dataclasses.replace(
        stacked, pose=pick(stacked.pose), fx=pick(stacked.fx),
        fy=pick(stacked.fy), cx=pick(stacked.cx), cy=pick(stacked.cy),
        image=None if stacked.image is None else pick(stacked.image),
        uid=stacked.uid.index_select(0, idx))
