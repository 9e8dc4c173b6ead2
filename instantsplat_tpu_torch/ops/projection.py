"""3D Gaussian -> 2D screen-space EWA projection in structured form (port
of instantsplat_tpu/ops/projection.py).

The main path projects in column form (ops/frontend.compute_columns);
this is the same arithmetic over [N, 3] means and [N, 3, 3] covariances,
for callers that hold those: the 1.3 * tan(fov/2) clamp of the Jacobian's
footprint, cov2D = J W Sigma W^T J^T plus the 0.3 px low-pass, the
3-sigma ceil radius, pixel centres x = fx * X/Z + cx, and the z > 0.2
near cull. Differentiable in means, covariances and the pose (R, t).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_CULL_Z = 0.2  # CUDA rasterizer's in_frustum near plane
LOW_PASS = 0.3  # screen-space dilation added to the cov2D diagonal


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor  # [N, 2] pixel coords
    cov2d: torch.Tensor  # [N, 3] (a, b, c) of the 2x2 covariance
    conic: torch.Tensor  # [N, 3] inverse covariance (a, b, c)
    depth: torch.Tensor  # [N] view-space z
    radius: torch.Tensor  # [N] 3-sigma pixel radius (0 for culled)
    valid: torch.Tensor  # [N] bool: in frustum and non-degenerate


def _clip(x: torch.Tensor, lim) -> torch.Tensor:
    """clip(x, -lim, lim) with JAX's tie gradient (half to each side),
    where torch.clamp would pass the whole gradient."""
    lim = torch.as_tensor(lim, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, -lim), lim)


def project_gaussians(means3d, cov3d, R, t, fx, fy, cx, cy, width: int,
                      height: int) -> ProjectedGaussians:
    """Project world-space Gaussians into one camera.

    means3d [N, 3] world centres; cov3d [N, 3, 3] world covariances; R
    [3, 3], t [3] the world-to-camera rotation and translation; fx, fy,
    cx, cy intrinsics in pixels; width, height the image size.
    """
    t_view = means3d @ R.T + t  # the pose-gradient path
    z = t_view[:, 2]

    tan_fovx = width / (2.0 * fx)
    tan_fovy = height / (2.0 * fy)
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8),
                              z)
    tx = _clip(t_view[:, 0] * inv_z, 1.3 * tan_fovx) * z
    ty = _clip(t_view[:, 1] * inv_z, 1.3 * tan_fovy) * z

    # EWA Jacobian (2x3) of the perspective projection at (tx, ty, z)
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z
    m0 = j00[:, None] * R[0] + j02[:, None] * R[2]  # rows of J @ R
    m1 = j11[:, None] * R[1] + j12[:, None] * R[2]

    s_m0 = torch.einsum("nij,nj->ni", cov3d, m0)
    s_m1 = torch.einsum("nij,nj->ni", cov3d, m1)
    a = torch.sum(m0 * s_m0, dim=-1) + LOW_PASS
    b = torch.sum(m0 * s_m1, dim=-1)
    c = torch.sum(m1 * s_m1, dim=-1) + LOW_PASS

    det = a * c - b * b
    inv_det = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.maximum(mid * mid - det,
                                          mid.new_tensor(0.1)))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    mean2d = torch.stack([fx * tx * inv_z + cx, fy * ty * inv_z + cy],
                         dim=-1)
    valid = ((z > NEAR_CULL_Z) & (det > 0)
             & (mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < width)
             & (mean2d[:, 1] + radius > 0)
             & (mean2d[:, 1] - radius < height))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(mean2d, torch.stack([a, b, c], -1), conic, z,
                              radius, valid)


def pack_pixel_features(mean2d: torch.Tensor,
                        conic: torch.Tensor) -> torch.Tensor:
    """[N, 6] monomial coefficients g6 with the log-falloff at pixel p as
    power(p) = [px^2, px*py, py^2, px, py, 1] . g6, where power = -1/2
    (p - mu)^T Conic (p - mu)."""
    A, B, C = conic[:, 0], conic[:, 1], conic[:, 2]
    mx, my = mean2d[:, 0], mean2d[:, 1]
    return torch.stack([
        -0.5 * A,
        -B,
        -0.5 * C,
        A * mx + B * my,
        B * mx + C * my,
        -(0.5 * A * mx * mx + B * mx * my + 0.5 * C * my * my),
    ], dim=-1)
