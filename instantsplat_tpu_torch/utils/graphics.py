"""Host-side geometry helpers (port of instantsplat_tpu/utils/graphics.py,
the one stage 2 uses)."""

from __future__ import annotations

import numpy as np


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
