"""Geometry front-end: activations, covariance, SH shading and EWA
projection as [N]-column arithmetic (port of instantsplat_tpu/ops/frontend.py).

The pose stays in autograd, so camera-pose gradients flow through the view
transform and the EWA Jacobian. Semantics kept from the reference:
covariance (R S)(R S)^T from normalized wxyz quaternions, camera-frame SH
view directions with color = max(SH + 0.5, 0), the EWA Jacobian with the
1.3*tan(fov/2) frustum clamp, the +0.3 px low-pass, the 3-sigma ceil
radius, the z > 0.2 near cull, det > 0 and the screen-bounds test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instantsplat_tpu_torch.ops.projection import LOW_PASS, NEAR_CULL_Z
from instantsplat_tpu_torch.utils import transforms as T
from instantsplat_tpu_torch.utils.sh import C0, C1, C2, C3, C4


class FrontendCols(NamedTuple):
    """Per-Gaussian screen-space columns, each [N]."""

    mx: torch.Tensor  # pixel x of the 2D mean
    my: torch.Tensor  # pixel y
    ca: torch.Tensor  # conic (inverse 2D covariance) a
    cb: torch.Tensor  # conic b
    cc: torch.Tensor  # conic c
    log_op: torch.Tensor  # log activated opacity
    r: torch.Tensor  # shaded color channels
    g: torch.Tensor
    b: torch.Tensor
    depth: torch.Tensor  # view-space z
    radius: torch.Tensor  # 3-sigma pixel radius (0 = culled)
    valid: torch.Tensor  # bool


def _max(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) with JAX's tie gradient (half to each side), where
    torch.clamp would pass the whole gradient. The floor is filled on
    the device (no host copy, so the front end can be captured)."""
    return torch.maximum(x, x.new_full((), floor))


def _sh_colors(deg: int, feat_t, x, y, z):
    """feat_t [K, 3, N] SH coefficients, unit view dirs (x, y, z) [N] ->
    3 x [N] color columns (basis shared across channels)."""
    basis = []
    if deg >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg >= 3:
        basis += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg >= 4:
        basis += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    out = []
    for c in range(3):
        col = C0 * feat_t[0, c]
        for k, bk in enumerate(basis):
            col = col + bk * feat_t[k + 1, c]
        out.append(col)
    return out


def _cov3d_cols(rot_t, s0, s1, s2):
    """Quaternion columns [4, N] + activated scales -> the six world
    covariance components (c00, c01, c02, c11, c12, c22) of (R S)(R S)^T."""
    w, x, y, z = rot_t[0], rot_t[1], rot_t[2], rot_t[3]
    inv = torch.rsqrt(w * w + x * x + y * y + z * z + 1e-12)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22
    return c00, c01, c02, c11, c12, c22


def compute_columns(gaussians, pose: torch.Tensor, fx, fy, cx, cy,
                    scale_modifier, active_sh_degree: int, height: int,
                    width: int) -> FrontendCols:
    """Activate, transform by `pose` ([7] w2c, differentiable), SH-shade
    and project every Gaussian. fx, fy, cx, cy are 0-dim float32 tensors."""
    R = T.quat_to_rotmat(pose[:4])
    t = pose[4:7]

    x3, y3, z3 = gaussians.xyz.unbind(1)
    rot_t = gaussians.rotation.T
    sc_t = torch.exp(gaussians.scaling.T) * scale_modifier
    log_op = torch.log(_max(torch.sigmoid(gaussians.opacity[:, 0]), 1e-12))

    # view-space means (the pose-gradient path)
    vx = R[0, 0] * x3 + R[0, 1] * y3 + R[0, 2] * z3 + t[0]
    vy = R[1, 0] * x3 + R[1, 1] * y3 + R[1, 2] * z3 + t[1]
    vz = R[2, 0] * x3 + R[2, 1] * y3 + R[2, 2] * z3 + t[2]

    # camera-frame SH view directions (reference quirk)
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    dinv = 1.0 / _max(norm, 1e-8)
    feats = torch.cat([gaussians.features_dc, gaussians.features_rest], dim=1)
    feat_t = feats.permute(1, 2, 0)  # [K, 3, N]
    cols_rgb = _sh_colors(active_sh_degree, feat_t, vx * dinv, vy * dinv,
                          vz * dinv)
    r, g, b = (_max(cval + 0.5, 0.0) for cval in cols_rgb)

    c00, c01, c02, c11, c12, c22 = _cov3d_cols(
        rot_t, sc_t[0], sc_t[1], sc_t[2])

    # EWA projection
    tan_fovx = width / (2.0 * fx)
    tan_fovy = height / (2.0 * fy)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    inv_z = 1.0 / torch.where(torch.abs(vz) < 1e-8,
                              torch.full_like(vz, 1e-8), vz)
    txz = torch.minimum(torch.maximum(vx * inv_z, -limx), limx)
    tyz = torch.minimum(torch.maximum(vy * inv_z, -limy), limy)
    tx = txz * vz
    ty = tyz * vz

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z

    m00 = j00 * R[0, 0] + j02 * R[2, 0]
    m01 = j00 * R[0, 1] + j02 * R[2, 1]
    m02 = j00 * R[0, 2] + j02 * R[2, 2]
    m10 = j11 * R[1, 0] + j12 * R[2, 0]
    m11 = j11 * R[1, 1] + j12 * R[2, 1]
    m12 = j11 * R[1, 2] + j12 * R[2, 2]

    sm0_0 = c00 * m00 + c01 * m01 + c02 * m02
    sm0_1 = c01 * m00 + c11 * m01 + c12 * m02
    sm0_2 = c02 * m00 + c12 * m01 + c22 * m02
    sm1_0 = c00 * m10 + c01 * m11 + c02 * m12
    sm1_1 = c01 * m10 + c11 * m11 + c12 * m12
    sm1_2 = c02 * m10 + c12 * m11 + c22 * m12
    a = m00 * sm0_0 + m01 * sm0_1 + m02 * sm0_2 + LOW_PASS
    bq = m00 * sm1_0 + m01 * sm1_1 + m02 * sm1_2
    c = m10 * sm1_0 + m11 * sm1_1 + m12 * sm1_2 + LOW_PASS

    det = a * c - bq * bq
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    ca = c * inv_det
    cb = -bq * inv_det
    cc = a * inv_det

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(_max(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    mx = fx * tx * inv_z + cx
    my = fy * ty * inv_z + cy

    valid = ((vz > NEAR_CULL_Z) & (det > 0)
             & (mx + radius > 0) & (mx - radius < width)
             & (my + radius > 0) & (my - radius < height))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return FrontendCols(mx, my, ca, cb, cc, log_op, r, g, b, vz, radius,
                        valid)
