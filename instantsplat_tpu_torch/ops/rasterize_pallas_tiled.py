"""2-D tiled compositor backend: the CUDA kernels K5 (forward) and K6
(backward).

Port of instantsplat_tpu/ops/rasterize_pallas_tiled.py. The image is cut
into BLOCK_ROWS x COL_W tiles; each splat is listed in the tiles of its
alpha-cutoff rectangle, clamped to dy_levels x dx_levels tiles, and each
tile composites its depth-ordered list (ops/rasterize_lists.py builds the
lists; csrc/rasterize_lists.cu holds the kernels). A backend string
"pallas-tiled:CF:DY:DX" allocates, overflows and drops exactly as in the
JAX package.

Not ported, as TPU workarounds: the [cap, 16] slot-row gather and the
chunk -> tile scalar-prefetch map (the kernels read the lists directly),
the candidate -> slot inverse map and its second sort (K6 adds each
entry's gradient at its splat's index with atomics, as K2 does), and the
host-side fill of untouched tiles (the kernel writes them).
"""

from __future__ import annotations

import math

import torch

from instantsplat_tpu_torch.ops.rasterize import CompositeOut, composite_out
from instantsplat_tpu_torch.ops.rasterize import cutoff_radius
from instantsplat_tpu_torch.ops.rasterize_lists import (
    BACKWARD_ARGTYPES,
    FORWARD_ARGTYPES,
    G_CHUNK,
    ListGeometry,
    SlotLists,
    build_lists,
    capacity,
    composite_lists,
    extent_1d,
    per_splat,
    round_up,
    splat_valid,
)
from instantsplat_tpu_torch.ops.rasterize_pallas import Kernel, pack_splats

BLOCK_ROWS = 8
COL_W = 128
CAP_FACTOR = 4  # slot capacity = CAP_FACTOR * N + per-tile alignment slack
DY_LEVELS = 4  # max row-blocks a Gaussian may span (extent clamp, flagged)
DX_LEVELS = 2  # max column-buckets a Gaussian may span
CTA_COLS = 32  # pixels per row of a CTA of K5/K6 (8 x 32 spans of a tile)

K5 = Kernel("k5_forward", FORWARD_ARGTYPES, "rasterize_lists.cu")
K6 = Kernel("k6_backward", BACKWARD_ARGTYPES, "rasterize_lists.cu")


def geometry(height: int, width: int) -> ListGeometry:
    return ListGeometry(BLOCK_ROWS, COL_W, round_up(height, BLOCK_ROWS)
                        // BLOCK_ROWS, round_up(width, COL_W) // COL_W)


def _build_tiles(mean2d, conic, log_opacity, valid, geom: ListGeometry,
                 cap: int, dy_levels: int, dx_levels: int) -> SlotLists:
    """Per-tile lists (port of rasterize_pallas_tiled.py::_build_tiles):
    candidates over each splat's tile rectangle, clamped to dy_levels x
    dx_levels, keyed tile * N + splat."""
    n_rb, n_cb = geom.n_rows, geom.n_cols
    r = cutoff_radius(conic, log_opacity, valid)
    ylo, yhi = extent_1d(mean2d[:, 1], r, BLOCK_ROWS, n_rb)
    xlo, xhi = extent_1d(mean2d[:, 0], r, COL_W, n_cb)
    yhi_c = torch.minimum(yhi, ylo + dy_levels - 1)
    xhi_c = torch.minimum(xhi, xlo + dx_levels - 1)
    ext_overflow = ((yhi > yhi_c) | (xhi > xhi_c)).any()
    dev = mean2d.device
    rbc = ylo[:, None] + torch.arange(dy_levels, device=dev)  # [N, Dy]
    cbc = xlo[:, None] + torch.arange(dx_levels, device=dev)  # [N, Dx]
    ok = (rbc <= yhi_c[:, None])[:, :, None] & \
        (cbc <= xhi_c[:, None])[:, None, :]
    tile = (rbc.clamp(0, n_rb - 1)[:, :, None] * n_cb
            + cbc.clamp(0, n_cb - 1)[:, None, :])
    n = mean2d.shape[0]
    return build_lists(ok.reshape(n, -1), tile.reshape(n, -1), geom.n_seg,
                       cap, ext_overflow)


def _caps(n: int, geom: ListGeometry, cap_factor, dy_levels, dx_levels):
    cf = CAP_FACTOR if cap_factor is None else cap_factor
    dy = DY_LEVELS if dy_levels is None else dy_levels
    dx = DX_LEVELS if dx_levels is None else dx_levels
    return capacity(cf, n, geom.n_seg), dy, dx


def tile_lists(packed: torch.Tensor, height: int, width: int,
               cap_factor: int | None = None, dy_levels: int | None = None,
               dx_levels: int | None = None):
    """(SlotLists, ListGeometry) of a packed, depth-sorted [N, 10] array
    for the capacities of "pallas-tiled:CF:DY:DX" (None = the defaults).
    Raises where tile * N + splat keys would pass int32, as JAX does."""
    n = packed.shape[0]
    geom = geometry(height, width)
    if geom.n_seg * (n + 1) >= 2**31:
        raise ValueError(
            f"tiled rasterizer key space overflow: {geom.n_seg} tiles x "
            f"{n} splats needs > int32 keys; use the 1-D binned or dense "
            "backend for this shape")
    cap, dy, dx = _caps(n, geom, cap_factor, dy_levels, dx_levels)
    p = packed.detach()
    return _build_tiles(p[:, :2], p[:, 2:5], p[:, 5], splat_valid(p), geom,
                        cap, dy, dx), geom


def composite_tiles_2d_packed(packed: torch.Tensor, height: int, width: int,
                              bg=None, cap_factor: int | None = None,
                              dy_levels: int | None = None,
                              dx_levels: int | None = None) -> CompositeOut:
    """Composite a packed, depth-sorted [N, 10] splat array (columns mx, my,
    conic a b c, log-opacity (-inf = invalid), r, g, b, depth) over 2-D
    tile lists: K5/K6 for a CUDA tensor, the plain version for a CPU one.
    Differentiable w.r.t. `packed` and `bg`."""
    lists, geom = tile_lists(packed, height, width, cap_factor, dy_levels,
                             dx_levels)
    acc, tfin = composite_lists(packed, lists, geom, height, width, K5, K6)
    return composite_out(acc, tfin, bg)


def composite_tiles_2d(mean2d, conic, log_opacity, colors, depth, valid,
                       height: int, width: int, bg=None,
                       cap_factor: int | None = None,
                       dy_levels: int | None = None,
                       dx_levels: int | None = None) -> CompositeOut:
    """Drop-in for rasterize.composite over the tiled kernels: the six
    depth-sorted arrays, packed and composited by
    `composite_tiles_2d_packed`."""
    return composite_tiles_2d_packed(
        pack_splats(mean2d, conic, log_opacity, colors, depth, valid),
        height, width, bg, cap_factor, dy_levels, dx_levels)


def tile_overflow(mean2d, conic, log_opacity, valid, height: int,
                  width: int, cap_factor: int | None = None,
                  dy_levels: int | None = None,
                  dx_levels: int | None = None) -> torch.Tensor:
    """True if the tiled backend would drop pairs for this scene (capacity
    or extent-clamp exhaustion)."""
    geom = geometry(height, width)
    cap, dy, dx = _caps(mean2d.shape[0], geom, cap_factor, dy_levels,
                        dx_levels)
    return _build_tiles(mean2d, conic, log_opacity, valid, geom, cap, dy,
                        dx).overflow


def _tile_requirements_impl(mean2d, conic, log_opacity, valid, height: int,
                            width: int):
    """(cap_factor float32, dy, dx) this scene state needs for a drop-free
    tiled build. Per-tile counts from a 2-D difference array."""
    n = mean2d.shape[0]
    geom = geometry(height, width)
    n_rb, n_cb = geom.n_rows, geom.n_cols
    r = cutoff_radius(conic, log_opacity, valid)
    ylo, yhi = extent_1d(mean2d[:, 1], r, BLOCK_ROWS, n_rb)
    xlo, xhi = extent_1d(mean2d[:, 0], r, COL_W, n_cb)
    ext_y = (yhi - ylo + 1).clamp(min=0)
    ext_x = (xhi - xlo + 1).clamp(min=0)
    one = ((ext_y > 0) & (ext_x > 0)).long()
    y0, y1 = ylo.clamp(0, n_rb), (yhi + 1).clamp(0, n_rb)
    x0, x1 = xlo.clamp(0, n_cb), (xhi + 1).clamp(0, n_cb)
    diff = torch.zeros((n_rb + 1, n_cb + 1), dtype=torch.int64,
                       device=mean2d.device)
    for (yy, xx), sign in (((y0, x0), 1), ((y0, x1), -1), ((y1, x0), -1),
                           ((y1, x1), 1)):
        diff.index_put_((yy, xx), sign * one, accumulate=True)
    counts = diff.cumsum(0).cumsum(1)[:n_rb, :n_cb]
    padded = (counts + G_CHUNK - 1) // G_CHUNK * G_CHUNK
    # alignment slack is added back by the capacity formula
    need = (padded.sum() - n_rb * n_cb * G_CHUNK).clamp(min=0)
    return per_splat(need, n), int(ext_y.max()), int(ext_x.max())


def sizing_margin_2d(cf_raw: float, dy_raw: int,
                     dx_raw: int) -> tuple[int, int, int]:
    """Raw drop-free (cap_factor, dy, dx) -> capacities with margin for
    scene drift during training (the trainer re-sizes every 250
    iterations, so margins only bound that window's drift)."""
    dy, dx = int(dy_raw), int(dx_raw)
    return (max(CAP_FACTOR, math.ceil(float(cf_raw)) + 1),
            max(3, dy + max(1, dy // 4)),
            max(2, dx + max(1, dx // 4)))


def tile_requirements(mean2d, conic, log_opacity, valid, height: int,
                      width: int) -> tuple[int, int, int]:
    """(cap_factor, dy_levels, dx_levels) that make the tiled backend
    drop-free for THIS scene state, plus drift margin."""
    cf, dy, dx = _tile_requirements_impl(mean2d, conic, log_opacity, valid,
                                         height, width)
    return sizing_margin_2d(float(cf), dy, dx)
