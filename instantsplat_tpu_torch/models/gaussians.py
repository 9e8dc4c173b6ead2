"""3D Gaussian scene parameters (port of instantsplat_tpu/models/gaussians.py).

A dataclass of raw (pre-activation) parameter tensors plus the learnable
per-view poses, with the same field names and shapes as the JAX pytree:

  xyz [N,3], features_dc [N,1,3], features_rest [N,(D+1)^2-1,3],
  scaling [N,3] (log), rotation [N,4] (wxyz), opacity [N,1] (logit),
  cam_poses [V,7] (w2c quat + trans), max_sh_degree D.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.ops.knn import mean_knn_dist2
from instantsplat_tpu_torch.utils import sh as SH
from instantsplat_tpu_torch.utils import transforms as T

def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log(x / (1 - x)) (reference utils/general_utils.py:18)."""
    return torch.log(x / (1 - x))


# the differentiable fields, in checkpoint order
PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "cam_poses")


@dataclasses.dataclass
class GaussianModel:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    cam_poses: torch.Tensor
    max_sh_degree: int = 3

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_views(self) -> int:
        return self.cam_poses.shape[0]

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return T.quat_normalize(self.rotation)

    def get_features(self) -> torch.Tensor:
        """[N, (D+1)^2, 3] full SH coefficient stack."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def get_pose(self, uid) -> torch.Tensor:
        return self.cam_poses[uid]

    def get_covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        """World-space covariance [N, 3, 3] per Gaussian: (R S)(R S)^T."""
        L = T.quat_to_rotmat(self.get_rotation()) * (
            self.get_scaling() * scale_modifier)[:, None, :]
        return L @ L.transpose(-1, -2)

    def replace(self, **kw) -> "GaussianModel":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f) for f in PARAM_FIELDS]

    @classmethod
    def create_from_pcd(
        cls,
        points: np.ndarray,
        colors: np.ndarray,
        cam_poses: Optional[np.ndarray] = None,
        max_sh_degree: int = 3,
        init_opacity: float = 0.1,
        scale_override: Optional[np.ndarray] = None,
        device="cuda",
    ) -> "GaussianModel":
        """DC SH from RGB, zero higher bands, isotropic log-scale from
        sqrt(mean 3-NN squared distance) (or `scale_override`), identity
        rotation, opacity `init_opacity`."""
        pts = torch.as_tensor(np.array(points, np.float32), device=device)
        n = pts.shape[0]
        cols = torch.as_tensor(np.array(colors, np.float32), device=device)
        features_dc = SH.rgb_to_sh(cols)[:, None, :]
        k = SH.num_sh_coeffs(max_sh_degree)
        features_rest = torch.zeros((n, k - 1, 3), device=device)
        if scale_override is not None:
            s = torch.log(torch.as_tensor(
                np.asarray(scale_override, np.float32), device=device))
        else:
            s = torch.log(torch.sqrt(mean_knn_dist2(pts, k=3)))
        scales = s[:, None].repeat(1, 3)
        rots = torch.zeros((n, 4), device=device)
        rots[:, 0] = 1.0
        # inverse_sigmoid(init_opacity), computed in float32
        op = torch.full((n, 1), init_opacity, device=device)
        opacities = torch.log(op / (1 - op))
        if cam_poses is None:
            cam_poses = np.zeros((0, 7), np.float32)
        return cls(
            xyz=pts,
            features_dc=features_dc,
            features_rest=features_rest,
            scaling=scales,
            rotation=rots,
            opacity=opacities,
            cam_poses=torch.as_tensor(np.asarray(cam_poses, np.float32),
                                      device=device),
            max_sh_degree=max_sh_degree,
        )

    @staticmethod
    def init_cam_poses_from_w2c(w2c_list) -> np.ndarray:
        """[V,4,4] world-to-camera matrices -> [V,7] float32 pose vectors."""
        return T.matrix_to_pose_np(np.stack([np.asarray(m) for m in w2c_list]))
