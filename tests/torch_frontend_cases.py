"""Scenes for the front end's two routes (ops/frontend.py): Gaussians with
every field drawn at random, SH degree 3 rows, a pose and intrinsics, and
rows placed on the edges the front end decides at: the near plane, off
screen, a covariance that overflows (its det is NaN), one that
underflows, a zero quaternion, a colour exactly at the clamp and means
exactly on the frustum clamp (under the identity pose)."""

import numpy as np
import torch

from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.utils.sh import C0


def _color_tie() -> np.float32:
    """An f with float32 C0 * f + 0.5 == 0, as the plain version and the
    kernel round it: max(SH + 0.5, 0) then sits on its tie."""
    f = np.float32(-0.5 / C0)
    for _ in range(64):
        if np.float32(np.float32(C0) * f) + np.float32(0.5) == 0:
            return f
        f = np.nextafter(f, np.float32(-1.0), dtype=np.float32)
    raise AssertionError("no float32 tie of the colour clamp found")


def frontend_scene(n: int, height: int, width: int, seed: int, device,
                   degenerate: bool = True, identity: bool = False):
    """-> (GaussianModel with max_sh_degree 3, pose [7], fx, fy, cx, cy
    (0-dim float32)). degenerate: rows 8-10 overflow, underflow and carry
    a zero quaternion (NaN columns: leave them out where a pose gradient
    sums over every row). identity: the identity pose, under which rows
    11-12 sit exactly on the frustum clamp's two ties."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [1.5, 1.0, 1.5] + [0.0, 0.0, 3.0]
    xyz[:5, 2] = [0.1, 0.19, 0.2, -1.0, 0.21]  # at and behind the near plane
    xyz[5:8] = [[50.0, 0.0, 3.0], [0.0, -40.0, 3.0], [-30.0, 0.0, 2.0]]
    fields = dict(
        xyz=xyz, features_dc=rng.normal(size=(n, 1, 3)) * 0.8,
        features_rest=rng.normal(size=(n, 15, 3)) * 0.3,
        scaling=rng.normal(size=(n, 3)) * 0.7 - 3.0,
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)) * 2.0, cam_poses=np.zeros((1, 7)))
    fields = {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in fields.items()}
    fields["features_dc"][13] = float(_color_tie())
    if degenerate:
        fields["scaling"][8] = 40.0  # exp overflows: a NaN det, culled
        fields["scaling"][9] = -60.0  # exp underflows: the low-pass alone
        fields["rotation"][10] = 0.0
    if identity:
        pose = np.array([1.0, 0, 0, 0, 0, 0, 0])
    else:
        q = rng.normal(size=4) * [1.0, 0.05, 0.05, 0.05]
        q[0] = abs(q[0]) + 1.0
        pose = np.concatenate([q, rng.normal(size=3) * 0.1])
    fx = torch.tensor(0.9 * width, dtype=torch.float32)
    fy = fx * 1.05
    if identity:
        # under the identity pose v = p; at z = 2 (1 / z exact) x / z is
        # the clamp's bound exactly, computed as the front end computes it
        lim = float(1.3 * (width / (2.0 * fx.to(device))))
        fields["xyz"][11] = torch.tensor([2.0 * lim, 0.0, 2.0])
        fields["xyz"][12] = torch.tensor([-2.0 * lim, 0.5, 2.0])
    g = GaussianModel(**{k: v.to(device) for k, v in fields.items()},
                      max_sh_degree=3)
    return (g, torch.as_tensor(pose, dtype=torch.float32, device=device),
            fx.to(device), fy.to(device),
            torch.tensor(width / 2 + 1.5, device=device),
            torch.tensor(height / 2 - 2.0, device=device))


def packed_plain(g, pose, fx, fy, cx, cy, degree, height, width):
    """compute_columns' columns stacked as the kernel writes its rows (in
    Gaussian order: -inf log-opacity and the 1e30 key on culled rows).
    -> (rows [N, 10], FrontendCols)."""
    from instantsplat_tpu_torch.ops.frontend import compute_columns

    c = compute_columns(g, pose, fx, fy, cx, cy, 1.0, degree, height, width)
    key = torch.where(c.valid, c.depth, torch.full_like(c.depth, 1e30))
    lo = torch.where(c.valid, c.log_op, torch.full_like(c.log_op, -torch.inf))
    return torch.stack([c.mx, c.my, c.ca, c.cb, c.cc, lo, c.r, c.g, c.b,
                        key], 1), c
