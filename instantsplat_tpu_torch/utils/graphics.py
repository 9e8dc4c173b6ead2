"""Host-side geometry helpers (port of instantsplat_tpu/utils/graphics.py):
the GL-convention matrices of the reference's graphics_utils, kept for
interop (the renderer takes fx, fy, cx, cy), and the view-depth scale
init behind --init_scale_from_view_depth."""

from __future__ import annotations

import numpy as np


def get_world2view2(R, t, translate=np.zeros(3), scale=1.0):
    """GL-style w2c [4, 4] float32 with optional recentering. The
    reference's convention: R is the transposed (c2w) rotation and t the
    w2c translation."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def get_projection_matrix(znear, zfar, fovx, fovy):
    """Row-major perspective projection [4, 4] float32."""
    top = np.tan(fovy / 2) * znear
    right = np.tan(fovx / 2) * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.astype(np.float32)


def scale_from_view_depth(points, w2c_mats, focals):
    """Per-point Gaussian scale from projected view depth: the minimum
    camera-frame z over the training views, clipped to >= 0.01, divided by
    the mean focal (the size one pixel subtends at that depth).

    points [N,3]; w2c_mats [V,4,4]; focals [V, 2] (fx, fy) or [V].
    """
    points = np.asarray(points)
    depth = np.min(np.stack([points @ w2c[:3, 2] + w2c[2, 3]
                             for w2c in np.asarray(w2c_mats)]), axis=0)
    depth = np.clip(depth, 0.01, depth.max())
    return depth / float(np.asarray(focals, np.float64).mean())
