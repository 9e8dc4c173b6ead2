"""Dense compositor backend: the CUDA kernels KR (rectangles), K1 (forward)
and K2 (backward).

Port of instantsplat_tpu/ops/rasterize_pallas.py. The TPU file holds the
Pallas kernels `_fwd_kernel` (K1) and `_bwd_kernel` (K2) and the culling
bitmap `_row_block_bitmap` in front of them; here they are hand-written
CUDA for Hopper in csrc/rasterize.cu (its header note says what bounds
them and how the design answers), bound with ctypes. What the
TPU version needed for its own layout is not carried over: the 128-lane
width padding, the VMEM strips, the bf16-split MXU prefix sums, the
per-strip backward loop.

`composite_tiles_packed` is the entry point; `composite_tiles` is its
structured twin, a drop-in for rasterize.composite that takes the six
sorted arrays and packs them (`pack_splats`). On a CPU tensor it runs the
plain PyTorch version (`composite_plain`, ops/rasterize.py) and its
autograd; on a CUDA tensor it launches k1_rects (tile rectangles and the
scan's coarse mask, one kernel) and K1 and, in the backward,
K2 — or raises. There is no fallback from one to the other.

What the kernels cull by has a plain version here, which the card compares
with the kernels and the CPU tests hold to "never drops a contributor":
`scan_plain` (k1_rects: `splat_rects` packed to int16, `group_tile_mask`)
and `block_masks` (the per-warp cull inside K1/K2; `span_block_masks` is
the same test over any CTA's span, as the list kernels K3-K6 use it).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from instantsplat_tpu_torch.ops.cuda_build import Kernel
from instantsplat_tpu_torch.ops.rasterize import (  # noqa: F401 (re-export)
    ALPHA_EPS,
    LOG_ALPHA_EPS,
    LOG_TERM,
    CompositeOut,
    composite_out,
    composite_plain,
    cutoff_radius,
    pack_columns,
)

TILE = 16  # pixels per tile side (csrc/rasterize.cu TILE)
BLOCK_W, BLOCK_H = 8, 4  # pixels of a tile that one warp owns
GROUP = 32  # depth-consecutive splats per bit of the coarse mask (GROUP)
WORD_SPLATS = 32 * GROUP  # splats per mask word
GRAD_W = 12  # floats per splat in K2's gradient scratch (GRAD_W)
QUEUE_CAP = 2048  # queue entries a tile's CTA holds at a time (QCAP)
NCOL = 10
_DEAD = 32767  # lower bound of an empty rectangle: no tile index reaches it
MAX_TILES = _DEAD - 1  # tiles per image side that an int16 bound can index


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KR = Kernel("k1_rects", [_P, _I, _I, _I, _F, _P, _P, _P])
K1 = Kernel("k1_forward",
            [_P, _I, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P])
K2 = Kernel("k2_backward",
            [_P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P])


class DenseScan(NamedTuple):
    """What the dense kernels' scan reads, per splat and per tile (written
    by the kernel k1_rects on the card, by `scan_plain` elsewhere)."""

    # [n_words * 1024, 4] int16 tile rectangles (pack_rects): the N
    # splats', then empty ones up to a whole mask word
    rect: torch.Tensor
    # [n_words, n_tiles] int32 coarse mask (group_tile_mask)
    mask: torch.Tensor


def _tiles(height: int, width: int):
    return -(-width // TILE), -(-height // TILE)


def _cover(rect: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[N, n_ty, n_tx] bool: rectangle n covers tile (tx, ty). O(N * tiles)
    memory."""
    n_tx, n_ty = _tiles(height, width)
    tx = torch.arange(n_tx, device=rect.device)[None]
    ty = torch.arange(n_ty, device=rect.device)[None]
    cx = (tx >= rect[:, 0:1]) & (tx <= rect[:, 1:2])
    cy = (ty >= rect[:, 2:3]) & (ty <= rect[:, 3:4])
    return cy[:, :, None] & cx[:, None, :]


def splat_rects(packed: torch.Tensor, height: int, width: int):
    """Per-splat tile rectangles [N, 4] int32 (x_lo, x_hi, y_lo, y_hi),
    inclusive, in 16-px tile units: the plain version of k1_rects'
    rectangles.

    The extent is the alpha-cutoff radius (ops/rasterize.py::cutoff_radius,
    the TPU kernel's row bitmap radius, rasterize_pallas.py::
    _row_block_bitmap). Splats that can never contribute (invalid rows
    carry log-opacity -inf) get the empty rectangle (_DEAD, -1, _DEAD, -1).
    """
    mx, my = packed[:, 0], packed[:, 1]
    r = cutoff_radius(packed[:, 2:5], packed[:, 5], packed[:, 5] > -torch.inf)
    n_tx, n_ty = _tiles(height, width)

    def span(c, n_t):
        t_lo = torch.floor((c - r) / TILE).clamp(-1, n_t).to(torch.int32)
        t_hi = torch.floor((c + r) / TILE).clamp(-1, n_t).to(torch.int32)
        return t_lo.clamp(min=0), t_hi.clamp(max=n_t - 1)

    x_lo, x_hi = span(mx, n_tx)
    y_lo, y_hi = span(my, n_ty)
    alive = (r >= 0) & (x_lo <= x_hi) & (y_lo <= y_hi)
    dead_lo = torch.full_like(x_lo, _DEAD)
    dead_hi = torch.full_like(x_hi, -1)
    return torch.stack([
        torch.where(alive, x_lo, dead_lo), torch.where(alive, x_hi, dead_hi),
        torch.where(alive, y_lo, dead_lo), torch.where(alive, y_hi, dead_hi),
    ], dim=1).contiguous()


def span_block_masks(rows: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                     span_rows: int, span_cols: int):
    """[M] int32: for packed rows [M, 10] queued at a CTA whose span_rows x
    span_cols pixels start at pixel (x0, y0) [M], the 8x4-pixel blocks of
    the span (bit = block row * blocks per row + block column, one warp
    each) in which the splat can reach alpha >= 1/255. A warp skips the
    queued splats that miss its block. Plain version of
    csrc/compositor.cuh::block_mask; the spans are 16 x 16 (K1/K2), 4 x 64
    (K3/K4) and 8 x 32 (K5/K6), eight blocks each.

    Per pixel row, q = ca dx^2 + 2 cb dx dy + cc dy^2 is least over a
    block's x range at dx = -cb dy / ca clamped to the range; the block is
    kept when that is within 2 (lo - log(1/255)) plus a slack far above the
    rounding of this and of the compositor's own power."""
    mx, my, ca, cb, cc, lo = (rows[:, c, None, None] for c in range(6))
    m2 = 2.0 * (lo - LOG_ALPHA_EPS)
    dev = rows.device
    row = torch.arange(span_rows, device=dev)
    dy = (y0[:, None, None] + row[None, :, None]) - my  # [M, rows, 1]
    xr = (x0[:, None, None] + torch.arange(
        0, span_cols, BLOCK_W, device=dev)[None, None, :]) - mx
    dx = torch.minimum(torch.maximum(-cb / ca * dy, xr), xr + (BLOCK_W - 1))
    t1, t2, t3 = ca * dx * dx, 2.0 * cb * dx * dy, cc * dy * dy
    keep = t1 + t2 + t3 <= m2 + 1e-2 + 1e-5 * (t1 + t2.abs() + t3)
    n_blocks = span_rows // BLOCK_H * (span_cols // BLOCK_W)
    blocks = keep.view(-1, span_rows // BLOCK_H, BLOCK_H,
                       span_cols // BLOCK_W).any(2).reshape(-1, n_blocks)
    return (blocks.int() << torch.arange(n_blocks, device=dev)[None]).sum(
        1).int()


def block_masks(rows: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    """[M] int32: `span_block_masks` of the 16x16 tiles (tx, ty) [M] that
    K1/K2 composite (bit 2 * block row + block column)."""
    return span_block_masks(rows, tx * TILE, ty * TILE, TILE, TILE)


def pack_rects(rect: torch.Tensor) -> torch.Tensor:
    """int32 rectangles -> the kernels' int16 form, 8 bytes a splat (every
    bound fits: see _DEAD and MAX_TILES)."""
    return rect.to(torch.int16)


def unpack_rects(rect16: torch.Tensor) -> torch.Tensor:
    return rect16.to(torch.int32)


def group_tile_mask(rect: torch.Tensor, height: int, width: int):
    """Coarse level of the scan, [n_words, n_tiles] int32: bit b of
    mask[w, ty * n_tx + tx] is set when the rectangle of any of the GROUP
    sorted splats [GROUP * (32 w + b), GROUP * (32 w + b + 1)) covers tile
    (tx, ty). A tile reads the rectangles of marked groups only. Plain
    version of the mask k1_rects writes; O(N * tiles) memory."""
    n, dev = rect.shape[0], rect.device
    cover = _cover(rect, height, width).reshape(n, -1)
    n_words = -(-n // WORD_SPLATS)
    if n == 0:
        return torch.zeros((0, cover.shape[1]), dtype=torch.int32,
                           device=dev)
    pad = torch.zeros((n_words * WORD_SPLATS - n, cover.shape[1]),
                      dtype=torch.bool, device=dev)
    groups = torch.cat([cover, pad]).view(n_words, 32, GROUP, -1).any(2)
    bits = (groups.long() << torch.arange(32, device=dev)[None, :, None]
            ).sum(1)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32)


def mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """[n_words * 32, n_tiles] bool: the coarse mask, one row per group."""
    b = (mask[:, None, :].long() >> torch.arange(
        32, device=mask.device)[None, :, None]) & 1
    return b.reshape(-1, mask.shape[1]).bool()


def scan_plain(packed: torch.Tensor, height: int, width: int) -> DenseScan:
    """Plain version of the kernel k1_rects."""
    rect = splat_rects(packed, height, width)
    pad = -rect.shape[0] % WORD_SPLATS
    padded = torch.cat([rect, torch.tensor(
        [[_DEAD, -1, _DEAD, -1]], dtype=torch.int32,
        device=rect.device).expand(pad, 4)])
    return DenseScan(pack_rects(padded),
                     group_tile_mask(rect, height, width))


def covered_tiles(rect: torch.Tensor, height: int, width: int):
    """(splat [M], tx [M], ty [M]): every (splat, tile) pair whose int32
    rectangle covers the tile, i.e. every queue entry of K1. O(N * tiles)
    memory."""
    j, y, x = torch.nonzero(_cover(rect, height, width), as_tuple=True)
    return j, x, y


def scan_counts(packed: torch.Tensor, scan: DenseScan, height: int,
                width: int):
    """(rectangle tests per launch of K1, queue entries, evaluated (pixel,
    splat) pairs): 32 tests per marked (group, tile); one queue entry per
    covered (splat, tile); 32 pixels per 8x4 block of a queue entry's block
    mask. The latched stop, which ends a pixel's walk early, is not
    counted."""
    tests = int(mask_bits(scan.mask).sum()) * GROUP
    j, tx, ty = covered_tiles(unpack_rects(scan.rect), height, width)
    blocks = block_masks(packed[j], tx, ty)
    n_blocks = sum(int(((blocks >> b) & 1).sum()) for b in range(8))
    return tests, len(j), n_blocks * BLOCK_W * BLOCK_H


def _check(t: torch.Tensor, name: str, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_packed(packed: torch.Tensor, height: int, width: int) -> int:
    n = packed.shape[0]
    _check(packed, "packed", torch.float32, (n, NCOL))
    if packed.data_ptr() % 8:
        raise ValueError("packed must be 8-byte aligned")
    if not (0 < height <= MAX_TILES * TILE and 0 < width <= MAX_TILES * TILE):
        raise ValueError(f"image {width}x{height}: sides must be in "
                         f"[1, {MAX_TILES * TILE}]")
    return n


def _check_scan(scan: DenseScan, n: int, height: int, width: int) -> int:
    n_tx, n_ty = _tiles(height, width)
    n_words = -(-n // WORD_SPLATS)
    _check(scan.rect, "scan.rect", torch.int16, (n_words * WORD_SPLATS, 4))
    _check(scan.mask, "scan.mask", torch.int32, (n_words, n_tx * n_ty))
    return n_words


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k1_rects(packed: torch.Tensor, height: int, width: int) -> DenseScan:
    """Launch k1_rects: rectangles and coarse mask in one kernel."""
    n = _check_packed(packed, height, width)
    n_tx, n_ty = _tiles(height, width)
    dev = packed.device
    n_words = -(-n // WORD_SPLATS)
    scan = DenseScan(
        torch.empty((n_words * WORD_SPLATS, 4), dtype=torch.int16,
                    device=dev),
        torch.empty((n_words, n_tx * n_ty), dtype=torch.int32, device=dev))
    if n:
        with torch.cuda.device(dev):
            KR(packed.data_ptr(), n, height, width, LOG_ALPHA_EPS,
               scan.rect.data_ptr(), scan.mask.data_ptr(), _stream())
    return scan


def k1_forward(packed: torch.Tensor, scan: DenseScan, height: int,
               width: int):
    """Launch K1. -> (acc [4,H,W] f32, tfin [H,W] f32, lc [H,W] int32)."""
    n = _check_packed(packed, height, width)
    n_words = _check_scan(scan, n, height, width)
    dev = packed.device
    acc = torch.empty((4, height, width), device=dev)
    tfin = torch.empty((height, width), device=dev)
    lc = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        K1(packed.data_ptr(), n, scan.rect.data_ptr(), scan.mask.data_ptr(),
           n_words, height, width, LOG_TERM, LOG_ALPHA_EPS, acc.data_ptr(),
           tfin.data_ptr(), lc.data_ptr(), _stream())
    return acc, tfin, lc


def k2_backward(packed: torch.Tensor, scan: DenseScan, g_acc: torch.Tensor,
                gtu: torch.Tensor, tfin: torch.Tensor, lc: torch.Tensor):
    """Launch K2. g_acc [4,H,W] = d loss / d acc, gtu [H,W] = (d loss /
    d tfin) * tfin. -> dpacked [N, 10] f32, the first ten columns of the
    16-byte-aligned [N, GRAD_W] scratch the kernel adds into."""
    height, width = tfin.shape
    n = _check_packed(packed, height, width)
    n_words = _check_scan(scan, n, height, width)
    _check(g_acc, "g_acc", torch.float32, (4, height, width))
    _check(gtu, "gtu", torch.float32, (height, width))
    _check(tfin, "tfin", torch.float32, (height, width))
    _check(lc, "lc", torch.int32, (height, width))
    scratch = torch.zeros((n, GRAD_W), device=packed.device)
    if scratch.data_ptr() % 16:
        raise ValueError("gradient scratch must be 16-byte aligned")
    with torch.cuda.device(packed.device):
        K2(packed.data_ptr(), n, scan.rect.data_ptr(), scan.mask.data_ptr(),
           n_words, height, width, LOG_ALPHA_EPS, g_acc.data_ptr(),
           gtu.data_ptr(), tfin.data_ptr(), lc.data_ptr(),
           scratch.data_ptr(), _stream())
    return grad_columns(scratch)


def grad_columns(scratch: torch.Tensor) -> torch.Tensor:
    """d(packed) [N, 10] out of the [N, GRAD_W] gradient scratch."""
    return scratch[:, :NCOL]


class _CompositeCuda(torch.autograd.Function):
    """packed [N,10] -> (acc [4,H,W], tfin [H,W]); k1_rects and K1
    forward, K2 backward."""

    @staticmethod
    def forward(ctx, packed, height: int, width: int):
        packed = packed.contiguous()
        scan = k1_rects(packed, height, width)
        acc, tfin, lc = k1_forward(packed, scan, height, width)
        ctx.save_for_backward(packed, *scan, tfin, lc)
        return acc, tfin

    @staticmethod
    def backward(ctx, g_acc, g_tfin):
        packed, rect, mask, tfin, lc = ctx.saved_tensors
        dpacked = k2_backward(packed, DenseScan(rect, mask),
                              g_acc.contiguous(),
                              (g_tfin * tfin).contiguous(), tfin, lc)
        return dpacked, None, None


def composite_packed(packed: torch.Tensor, height: int, width: int):
    """(acc [4,H,W], tfin [H,W]) of a depth-sorted packed [N,10] array:
    K1/K2 for a CUDA tensor, the plain version for a CPU tensor."""
    if packed.is_cuda:
        return _CompositeCuda.apply(packed, height, width)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    acc, tfin, _ = composite_plain(packed, height, width)
    return acc, tfin


def composite_tiles_packed(packed: torch.Tensor, height: int, width: int,
                           bg=None) -> CompositeOut:
    """Composite a packed, depth-sorted [N, 10] splat array (columns mx, my,
    conic a b c, log-opacity (-inf = invalid), r, g, b, depth).
    Differentiable w.r.t. `packed` and `bg`."""
    return composite_out(*composite_packed(packed, height, width), bg)


def pack_splats(mean2d, conic, log_opacity, colors, depth, valid):
    """Column-stack depth-sorted splats into the packed [N, 10] layout
    (-inf log-opacity on invalid rows). The render path builds it straight
    out of the depth sort (render/driver.prepare_packed_splats); this is
    for callers that hold the six sorted arrays."""
    return pack_columns(mean2d, conic, log_opacity, colors, depth, valid)


def composite_tiles(mean2d, conic, log_opacity, colors, depth, valid,
                    height: int, width: int, bg=None) -> CompositeOut:
    """Drop-in for rasterize.composite over the dense kernels: the arrays
    must be sorted front to back (rasterize.sort_by_depth). Differentiable
    w.r.t. every float input and `bg`; invalid rows get zero gradient."""
    return composite_tiles_packed(
        pack_splats(mean2d, conic, log_opacity, colors, depth, valid),
        height, width, bg)
