"""1-D binned compositor backend: the CUDA kernels K3 (forward) and K4
(backward).

Port of instantsplat_tpu/ops/rasterize_pallas_binned.py. The image is cut
into bands of BLOCK_ROWS rows at the 128-padded width; each splat is listed
in the bands of its alpha-cutoff y-extent, clamped to d_levels bands, and
each band composites its depth-ordered list (ops/rasterize_lists.py builds
the lists; csrc/rasterize_lists.cu holds the kernels). A backend string
"pallas-binned:CF:DL" allocates, overflows and drops exactly as in the JAX
package.

Not ported, as TPU workarounds: the VMEM strips the TPU composited in
(`_strip_plan`; the 512-row strips still bound `_bin_requirements_impl`'s
per-strip maximum, so the sizing matches JAX), the [cap, n_rb]
comparison-sum slot lookups (searchsorted and gathers here), the [cap, 16]
slot-row gather and the candidate -> slot inverse map (K4 adds each
entry's gradient at its splat's index with atomics, as K2 does).
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

BLOCK_ROWS = 4
STRIP_ROWS = 512  # the TPU strip height; bounds the sizing's per-strip max
CAP_FACTOR = 3  # slot capacity = CAP_FACTOR * N + per-band alignment slack
D_LEVELS = 16  # max row blocks a Gaussian may span (extent clamp, flagged)
COL_ALIGN = 128  # bands span the width rounded up to this
CTA_COLS = 64  # pixels per row of a CTA of K3/K4 (4 x 64 spans of a band)

K3 = Kernel("k3_forward", FORWARD_ARGTYPES, "rasterize_lists.cu")
K4 = Kernel("k4_backward", BACKWARD_ARGTYPES, "rasterize_lists.cu")


def geometry(height: int, width: int) -> ListGeometry:
    return ListGeometry(BLOCK_ROWS, round_up(width, COL_ALIGN),
                        round_up(height, BLOCK_ROWS) // BLOCK_ROWS, 1)


def _y_extent_blocks(mean2d, conic, log_opacity, valid, y0: int,
                     n_rows: int):
    """Per-splat inclusive row-block range [lo, hi] of the rows [y0, y0 +
    n_rows) at the alpha-cutoff radius (hi < lo => touches nothing)."""
    r = cutoff_radius(conic, log_opacity, valid)
    return extent_1d(mean2d[:, 1] - float(y0), r, BLOCK_ROWS,
                     n_rows // BLOCK_ROWS)


def _build_bins(mean2d, conic, log_opacity, valid, n_rows: int, cap: int,
                d_levels: int = D_LEVELS) -> SlotLists:
    """Per-band lists (port of rasterize_pallas_binned.py::_build_bins over
    the whole padded image): candidates over each splat's y-extent, clamped
    to d_levels bands, keyed band * N + splat."""
    lo, hi = _y_extent_blocks(mean2d, conic, log_opacity, valid, 0, n_rows)
    hi_c = torch.minimum(hi, lo + d_levels - 1)
    ext_overflow = (hi > hi_c).any()
    rb = lo[:, None] + torch.arange(d_levels, device=mean2d.device)
    return build_lists(rb <= hi_c[:, None], rb, n_rows // BLOCK_ROWS, cap,
                       ext_overflow)


def _caps(n: int, geom: ListGeometry, cap_factor, d_levels):
    cf = CAP_FACTOR if cap_factor is None else cap_factor
    dl = D_LEVELS if d_levels is None else d_levels
    return capacity(cf, n, geom.n_seg), dl


def bin_lists(packed: torch.Tensor, height: int, width: int,
              cap_factor: int | None = None, d_levels: int | None = None):
    """(SlotLists, ListGeometry) of a packed, depth-sorted [N, 10] array
    for the capacities of "pallas-binned:CF:DL" (None = the defaults)."""
    geom = geometry(height, width)
    cap, dl = _caps(packed.shape[0], geom, cap_factor, d_levels)
    p = packed.detach()
    return _build_bins(p[:, :2], p[:, 2:5], p[:, 5], splat_valid(p),
                       geom.n_rows * BLOCK_ROWS, cap, dl), geom


def composite_tiles_binned_packed(packed: torch.Tensor, height: int,
                                  width: int, bg=None,
                                  cap_factor: int | None = None,
                                  d_levels: int | None = None
                                  ) -> CompositeOut:
    """Composite a packed, depth-sorted [N, 10] splat array (columns mx, my,
    conic a b c, log-opacity (-inf = invalid), r, g, b, depth) over row-band
    lists: K3/K4 for a CUDA tensor, the plain version for a CPU one.
    Differentiable w.r.t. `packed` and `bg`."""
    lists, geom = bin_lists(packed, height, width, cap_factor, d_levels)
    acc, tfin = composite_lists(packed, lists, geom, height, width, K3, K4)
    return composite_out(acc, tfin, bg)


def composite_tiles_binned(mean2d, conic, log_opacity, colors, depth, valid,
                           height: int, width: int, bg=None,
                           cap_factor: int | None = None,
                           d_levels: int | None = None) -> CompositeOut:
    """Drop-in for rasterize.composite over the binned kernels: the six
    depth-sorted arrays, packed and composited by
    `composite_tiles_binned_packed`."""
    return composite_tiles_binned_packed(
        pack_splats(mean2d, conic, log_opacity, colors, depth, valid),
        height, width, bg, cap_factor, d_levels)


def bin_overflow(mean2d, conic, log_opacity, valid, height: int, width: int,
                 cap_factor: int | None = None,
                 d_levels: int | None = None) -> torch.Tensor:
    """True if the binned backend would drop pairs for this scene (capacity
    or extent-clamp exhaustion)."""
    geom = geometry(height, width)
    cap, dl = _caps(mean2d.shape[0], geom, cap_factor, d_levels)
    return _build_bins(mean2d, conic, log_opacity, valid,
                       geom.n_rows * BLOCK_ROWS, cap, dl).overflow


def _bin_requirements_impl(mean2d, conic, log_opacity, valid, height: int,
                           width: int):
    """(cap_factor float32, d_levels) this scene state needs for a
    drop-free binned build: the worst over the TPU's 512-row strips of the
    per-band counts (difference arrays) and of the clipped extents."""
    n = mean2d.shape[0]
    h_pad = round_up(height, BLOCK_ROWS)
    dev = mean2d.device
    worst_cf = torch.zeros((), dtype=torch.float32, device=dev)
    worst_dl = 0
    for y0 in range(0, h_pad, STRIP_ROWS):
        rows = min(STRIP_ROWS, h_pad - y0)
        n_rb = rows // BLOCK_ROWS
        lo, hi = _y_extent_blocks(mean2d, conic, log_opacity, valid, y0,
                                  rows)
        ext = (hi - lo + 1).clamp(min=0)
        worst_dl = max(worst_dl, int(ext.max()))
        live = (ext > 0).long()
        delta = torch.zeros(n_rb + 1, dtype=torch.int64, device=dev)
        delta.index_add_(0, lo.clamp(0, n_rb), live)
        delta.index_add_(0, (hi + 1).clamp(0, n_rb), -live)
        counts = delta.cumsum(0)[:n_rb]
        padded = (counts + G_CHUNK - 1) // G_CHUNK * G_CHUNK
        # alignment slack is added back by the capacity formula
        need = padded.sum() - n_rb * G_CHUNK
        worst_cf = torch.maximum(worst_cf, per_splat(need, n))
    return worst_cf, worst_dl


def sizing_margin(cf_raw: float, dl_raw: int) -> tuple[int, int]:
    """Raw drop-free (cap_factor, d_levels) -> capacities with margin for
    scene drift during training: cap_factor keeps the default floor;
    d_levels floors low with proportional headroom (the candidate sort is
    O(N * d_levels)); the trainer re-sizes every 250 iterations."""
    dl = int(dl_raw)
    return max(CAP_FACTOR, math.ceil(float(cf_raw)) + 1), \
        max(4, dl + max(2, dl // 4))


def bin_requirements(mean2d, conic, log_opacity, valid, height: int,
                     width: int) -> tuple[int, int]:
    """(cap_factor, d_levels) that make the binned backend drop-free for
    THIS scene state, plus drift margin."""
    cf, dl = _bin_requirements_impl(mean2d, conic, log_opacity, valid,
                                    height, width)
    return sizing_margin(float(cf), dl)
