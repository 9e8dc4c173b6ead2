"""Pose-differentiable render driver (port of instantsplat_tpu/render/driver.py).

The pose is an ordinary tensor input: autograd carries its gradient
through the front-end's world-to-camera transform. Backends:

- "oracle": the plain PyTorch compositor (ops/rasterize.py);
- "auto" and "pallas" (the name kept so the JAX CLI flags still parse):
  the dense kernels K1/K2 on a CUDA tensor, their plain version on a CPU
  tensor (ops/rasterize_pallas.py);
- "pallas-binned..." and "pallas-tiled...": not ported yet (ROADMAP
  queue 2, kernels K3-K6); they raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from instantsplat_tpu_torch.ops import rasterize, rasterize_pallas
from instantsplat_tpu_torch.ops.frontend import compute_columns

# Finite "invalid" depth sentinel: sorts after every real depth, and a zero
# compositing weight times it stays zero (inf would give 0 * inf = NaN).
_INVALID_DEPTH = 1e30


class RenderOut(NamedTuple):
    render: torch.Tensor  # [H, W, 3]
    alpha: torch.Tensor  # [H, W]
    depth: torch.Tensor  # [H, W]
    radii: torch.Tensor  # [N] screen-space 3-sigma radii (0 = culled)
    visibility: torch.Tensor  # [N] bool, radii > 0


def prepare_packed_splats(gaussians, pose, fx, fy, cx, cy, scale_modifier,
                          active_sh_degree: int, height: int, width: int):
    """Front-end + depth sort -> (packed [N, 10] sorted front to back, the
    unsorted FrontendCols). Columns: mx, my, conic a b c, log-opacity (-inf
    for invalid rows), r, g, b, depth; column 9 is the sorted key itself,
    so invalid rows carry the finite sentinel. The sort is stable, so the
    order is deterministic; tied invalid rows contribute nothing."""
    cols = compute_columns(gaussians, pose, fx, fy, cx, cy, scale_modifier,
                           active_sh_degree, height, width)
    key = torch.where(cols.valid, cols.depth,
                      torch.full_like(cols.depth, _INVALID_DEPTH))
    lo_m = torch.where(cols.valid, cols.log_op,
                       torch.full_like(cols.log_op, -torch.inf))
    key_sorted, perm = torch.sort(key, stable=True)
    packed = torch.stack([cols.mx, cols.my, cols.ca, cols.cb, cols.cc, lo_m,
                          cols.r, cols.g, cols.b], dim=1)[perm]
    return torch.cat([packed, key_sorted[:, None]], dim=1), cols


def _check_backend(backend: str) -> str:
    if backend == "auto":
        # a single render resolves to the dense kernels; the binned/tiled
        # probe of the JAX trainer is not ported (ROADMAP queue 1)
        return "pallas"
    if backend.startswith(("pallas-binned", "pallas-tiled")):
        raise NotImplementedError(
            f"backend {backend!r}: the binned and tiled kernels (K3-K6) are "
            "not ported yet (ROADMAP.md queue 2); use 'auto' or 'pallas'")
    if backend not in ("pallas", "oracle"):
        raise ValueError(f"unknown rasterizer backend: {backend}")
    return backend


def render(gaussians, camera, pose: Optional[torch.Tensor] = None,
           bg: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
           active_sh_degree: Optional[int] = None, chunk: int = 256,
           backend: str = "oracle") -> RenderOut:
    """Render one view.

    pose: optional [7] learnable w2c pose overriding camera.pose (pass
      `gaussians.get_pose(uid)` during joint optimisation).
    bg: [3] background (default black); differentiable.
    active_sh_degree: SH bands to evaluate; defaults to the maximum.
    chunk: splats per scan step of the oracle backend.
    """
    backend = _check_backend(backend)
    if pose is None:
        pose = camera.pose
    if bg is None:
        bg = torch.zeros(3, device=pose.device)
    if active_sh_degree is None:
        active_sh_degree = gaussians.max_sh_degree
    packed, cols = prepare_packed_splats(
        gaussians, pose, camera.fx, camera.fy, camera.cx, camera.cy,
        scale_modifier, active_sh_degree, camera.height, camera.width)
    if backend == "pallas":
        acc, tfin = rasterize_pallas.composite_packed(
            packed, camera.height, camera.width)
    else:
        acc, tfin, _ = rasterize.composite_plain(
            packed, camera.height, camera.width, chunk=chunk)
    out = rasterize.composite_out(acc, tfin, bg)
    return RenderOut(render=out.rgb, alpha=out.alpha, depth=out.depth,
                     radii=cols.radius, visibility=cols.valid)
