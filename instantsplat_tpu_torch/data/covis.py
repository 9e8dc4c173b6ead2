"""Co-visibility masks: suppress redundant points across views (port of
instantsplat_tpu/data/covis.py).

Reference behavior (utils/sfm_utils.py:342-415 compute_co_vis_masks /
cal_co_vis_mask, used at init_geo.py:74-76): views are visited in
decreasing-confidence order; for each view, the 3D points of all
higher-confidence views are projected into it, and pixels whose projected
depth agrees with the view's own (min-max normalized) depth map within
`depth_threshold` are marked redundant. The KEEP mask passed to point
saving is the negation.

Vectorized numpy (the reference loops per view over concatenated point
sets; we keep the same loop over views — V is 3..24 — but the projection
and scatter are vectorized).
"""

from __future__ import annotations

import numpy as np


def _normalize(d):
    lo, hi = d.min(), d.max()
    return (d - lo) / max(hi - lo, 1e-12)


def project_points(points, K, w2c):
    """[N,3] world -> ([N,2] pixels, [N] camera-space depth)."""
    pc = points @ np.asarray(w2c)[:3, :3].T + np.asarray(w2c)[:3, 3]
    z = pc[:, 2]
    uv = pc[:, :2] / np.maximum(z[:, None], 1e-12)
    uv = uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
    return uv, z


def compute_co_vis_masks(
    sorted_conf_indices, depthmaps, pointmaps, intrinsics, w2c,
    image_shape, depth_threshold=0.1,
):
    """-> [V, H, W] bool redundancy masks (True = co-visible, drop).

    Args:
      sorted_conf_indices: view indices in decreasing mean confidence.
      depthmaps: [V, H, W] (or flattenable) per-view depths.
      pointmaps: [V, H, W, 3] per-view world-space points.
      intrinsics: [V, 3, 3].
      w2c: [V, 4, 4].
    """
    v, h, w = image_shape
    depthmaps = np.asarray(depthmaps).reshape(v, h, w)
    pointmaps = np.asarray(pointmaps).reshape(v, h, w, 3)
    masks = np.zeros((v, h, w), bool)

    for i, curr in enumerate(sorted_conf_indices):
        if i == 0:
            continue  # most confident view keeps everything
        before = sorted_conf_indices[:i]
        pts = pointmaps[before].reshape(-1, 3)
        # NOTE (reference parity): the projected points are compared against
        # the current view's normalized depth map using the SOURCE views'
        # normalized depths (sfm_utils.py:398-401) — not the reprojected
        # depth. We reproduce that exactly.
        src_depths = _normalize(depthmaps[before].reshape(-1))
        curr_depth = _normalize(depthmaps[curr])

        uv, _ = project_points(pts, intrinsics[curr], w2c[curr])
        ok = (
            (uv[:, 0] >= 0) & (uv[:, 0] < w)
            & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        )
        xi = uv[ok, 0].astype(int)
        yi = uv[ok, 1].astype(int)
        dd = np.abs(src_depths[ok] - curr_depth[yi, xi])
        keep = dd < depth_threshold
        m = np.zeros((h, w), bool)
        m[yi[keep], xi[keep]] = True
        masks[curr] = m
    return masks
