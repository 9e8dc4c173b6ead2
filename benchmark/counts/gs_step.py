"""Frozen counts of the work in one stage-2 step (gs_sh3), from its shapes
and from the contributing (pixel, splat) pairs of its inputs.

These count what the algorithm needs, not what a kernel happens to do, so
a roofline or an mfu reads the same work whatever implements it. Each
exp, log or sqrt counts as one operation; a compare or a select counts as
none.
"""

from __future__ import annotations

import torch

from benchmark.reference import gs_plain

# Compositor, per contributing (pixel, splat) pair.
# forward: d = p - mean (2); power = -1/2 (a dx^2 + c dy^2) - b dx dy (11);
# + log-opacity, exp, min (3); T (1 - alpha) as 1 - alpha, a product (2);
# weight alpha T (1); three colour accumulations (6)
PAIR_FWD = 25
# backward: alpha and T again (17); colour gradients, three products and
# sums (6); the alpha gradient against the colour behind (9); the colour
# behind, three fused products (6); d alpha / d power (1); power's
# gradient to the mean and conic (15); five mean/conic and one opacity
# accumulation (6)
PAIR_BWD = 60
# the tile rectangle of a splat (radius from the conic's eigenvalue and
# the opacity's cutoff, four bounds)
SPLAT_RECT = 35
# bytes a compositor pass must move: each splat row read (10 float32), the
# image's colour and transmittance written (4 float32 a pixel) in the
# forward; splat rows, their gradients and the colour gradient in the
# backward
SPLAT_ROW_BYTES = 40
PIXEL_FWD_BYTES = 16
PIXEL_BWD_BYTES = 16

# Front end, per Gaussian: the view transform (18), the quaternion's norm
# and rotation (30), R S and its Gram (9 + 30), the EWA Jacobian and
# J W Sigma W^T J^T (60), conic, eigenvalue and radius (20), the 2-D mean
# (6), degree-0 colour (9), log-sigmoid opacity (3): 185 forward, the
# backward twice that
GAUSSIAN_FRONTEND = 185 * 3
# SSIM + L1, per pixel and channel: five separable 11-tap blurs (220),
# the products (3), the map (15), L1 (3); the backward through the three
# blurs of the render and the map (170)
PIXEL_LOSS = 241 + 170
# Adam, per parameter element: m (3), v (4), sqrt, + eps, divide, times
# the factor, subtract (5)
ADAM_PER_ELEMENT = 12


def contributing_pairs(leaves: dict, view: int, fx: float, height: int,
                       width: int) -> int:
    """(pixel, splat) pairs that contribute to `view`'s image under the
    compositing rules, for the state `leaves`."""
    with torch.no_grad(), gs_plain.full_float32():
        cols, depth, valid, a, c = gs_plain.project(
            leaves, leaves["cam_poses"][view], fx, fx, height, width)
        order, ent, starts = gs_plain.tile_lists(cols, depth, valid, a, c,
                                                  height, width)
        rows = cols[order]
        n_tiles = starts.shape[0] - 1
        total = 0
        for t0 in range(0, n_tiles, gs_plain.TILE_BLOCK):
            total += gs_plain.contributing(
                rows, ent, starts, t0, min(t0 + gs_plain.TILE_BLOCK, n_tiles),
                height, width)
    return total


def compositor_work(pairs: int, n_splats: int, height: int,
                    width: int) -> tuple[float, float]:
    """(operations, bytes) of one forward + backward compositor pass."""
    ops = pairs * (PAIR_FWD + PAIR_BWD) + n_splats * SPLAT_RECT
    nbytes = (3 * n_splats * SPLAT_ROW_BYTES
              + height * width * (PIXEL_FWD_BYTES + PIXEL_BWD_BYTES))
    return float(ops), float(nbytes)


def step_flops(pairs: int, n_gaussians: int, n_params: int, height: int,
               width: int) -> float:
    """Floating-point operations of one training step."""
    return float(n_gaussians * GAUSSIAN_FRONTEND
                 + pairs * (PAIR_FWD + PAIR_BWD) + n_gaussians * SPLAT_RECT
                 + height * width * 3 * PIXEL_LOSS
                 + n_params * ADAM_PER_ELEMENT)
