"""Sorted splat lists per image segment, and their compositors.

Shared by the 1-D binned backend (ops/rasterize_pallas_binned.py; kernels
K3/K4) and the 2-D tiled backend (ops/rasterize_pallas_tiled.py; K5/K6).
Both cut the image into segments (4-row bands, or 8x128 tiles), list for
each segment the splats whose alpha-cutoff extent reaches it, in depth
order, and composite each segment over its own list.

The lists are built in plain torch exactly as the TPU backends build their
slot arrays (rasterize_pallas_binned.py::_build_bins,
rasterize_pallas_tiled.py::_build_tiles): one key segment * N + splat per
(splat, segment) candidate, sorted; per-segment starts and counts by
searchsorted; each segment's run padded to G_CHUNK=256 slots and laid out
back to back in a slot array of the backend's capacity; overflow when the
padded runs pass the capacity or an extent passes the level clamp. What
does not fit is dropped, list by list, as there. On the card the padding
is not materialised: a list is `order[seg_start : seg_start + seg_count]`,
seg_count being what fits (`slot_start` keeps the TPU slot position, so
the layout can be checked against the JAX package).

`composite_lists` is the entry point: on a CUDA tensor it launches the
backend's forward kernel and, in the backward, its backward kernel
(csrc/rasterize_lists.cu); on a CPU tensor it runs the plain version,
`composite_lists_plain`, which takes the same lists and walks each one
with the plain compositor's arithmetic (ops/rasterize.py::_chunk_step);
its autograd is the backward kernel's plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from instantsplat_tpu_torch.ops.rasterize import (
    LOG_TERM,
    _scan_chunks,
    cutoff_radius,
)
from instantsplat_tpu_torch.ops.rasterize_pallas import (
    NCOL,
    Kernel,
    _check,
    _stream,
)

G_CHUNK = 256  # slot alignment of each list in the TPU slot layout


class SlotLists(NamedTuple):
    """Per-segment splat lists (see the module docstring)."""

    order: torch.Tensor  # [n_cand] int32 sorted candidates' splat index
    seg_start: torch.Tensor  # [n_seg] int32 first entry in `order`
    seg_count: torch.Tensor  # [n_seg] int32 entries kept (fit in capacity)
    slot_start: torch.Tensor  # [n_seg] int32 position in the slot array
    overflow: torch.Tensor  # bool: pairs were dropped


class ListGeometry(NamedTuple):
    """Segments of seg_rows x seg_w pixels, n_rows x n_cols of them."""

    seg_rows: int
    seg_w: int
    n_rows: int
    n_cols: int

    @property
    def n_seg(self) -> int:
        return self.n_rows * self.n_cols


def extent_1d(center, r, block: int, n_blocks: int):
    """Inclusive block range [lo, hi] covered by center +- r (hi < lo =>
    touches nothing; (1, 0) for r < 0). Port of
    rasterize_pallas_tiled.py::_extent_1d; floors are clamped before the
    int cast."""
    lo = torch.floor((center - r) / block).clamp(-1, n_blocks).long()
    hi = torch.floor((center + r) / block).clamp(-1, n_blocks).long()
    lo, hi = lo.clamp(0, n_blocks), hi.clamp(-1, n_blocks - 1)
    dead = r < 0
    return (torch.where(dead, torch.ones_like(lo), lo),
            torch.where(dead, torch.zeros_like(hi), hi))


def splat_valid(packed: torch.Tensor) -> torch.Tensor:
    """Rows that can contribute: invalid rows carry log-opacity -inf."""
    return packed[:, 5] > -torch.inf


def build_lists(ok: torch.Tensor, seg: torch.Tensor, n_seg: int, cap: int,
                ext_overflow: torch.Tensor) -> SlotLists:
    """Lists from the candidates seg [N, D] (segment of each candidate
    level) where ok [N, D]: keys seg * N + splat, sorted; per-segment
    counts padded to G_CHUNK slots and laid out in a `cap`-slot array."""
    n = seg.shape[0]
    dev = seg.device
    gidx = torch.arange(n, device=dev)
    big = torch.iinfo(torch.int64).max
    keys = torch.where(ok, seg * n + gidx[:, None],
                       torch.full_like(seg, big)).reshape(-1)
    sk = torch.sort(keys).values
    bounds = torch.arange(n_seg + 1, device=dev) * n
    edges = torch.searchsorted(sk, bounds)
    start = edges[:-1]
    counts = edges[1:] - start
    padded = (counts + G_CHUNK - 1) // G_CHUNK * G_CHUNK
    pstart = torch.cumsum(padded, 0) - padded
    total = padded.sum()
    kept = torch.minimum(counts, cap - pstart).clamp(min=0)
    order = torch.where(sk < big, sk % n, torch.zeros_like(sk))
    i32 = torch.int32
    return SlotLists(order=order.to(i32), seg_start=start.to(i32),
                     seg_count=kept.to(i32), slot_start=pstart.to(i32),
                     overflow=(total > cap) | ext_overflow)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def per_splat(need: torch.Tensor, n: int) -> torch.Tensor:
    """need / n in float32 as the jitted JAX sizing computes it: XLA turns
    a division by a constant into a multiply by its float32 reciprocal,
    which can differ from the division in the last bit (and move a ceil)."""
    return need.to(torch.float32) * torch.tensor(1.0 / n,
                                                 dtype=torch.float32)


def capacity(cap_factor: int, n: int, n_seg: int) -> int:
    """Slot capacity of a backend string: cap_factor * N slots plus room for
    each segment's alignment padding (rasterize_pallas_binned.py:556,
    rasterize_pallas_tiled.py:567)."""
    return round_up(max(cap_factor * n, G_CHUNK) + n_seg * G_CHUNK, G_CHUNK)


# ---- kernels -----------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FORWARD_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P]
BACKWARD_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                     _P]


def _check_lists(packed, lists: SlotLists, geom: ListGeometry):
    n = packed.shape[0]
    _check(packed, "packed", torch.float32, (n, NCOL))
    _check(lists.order, "order", torch.int32, (lists.order.shape[0],))
    _check(lists.seg_start, "seg_start", torch.int32, (geom.n_seg,))
    _check(lists.seg_count, "seg_count", torch.int32, (geom.n_seg,))


def lists_forward(kernel: Kernel, packed: torch.Tensor, lists: SlotLists,
                  geom: ListGeometry, height: int, width: int):
    """Launch a list forward kernel (K3 or K5).
    -> (acc [4,H,W] f32, tfin [H,W] f32, lc [H,W] int32)."""
    _check_lists(packed, lists, geom)
    dev = packed.device
    acc = torch.empty((4, height, width), device=dev)
    tfin = torch.empty((height, width), device=dev)
    lc = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernel(packed.data_ptr(), lists.order.data_ptr(),
               lists.seg_start.data_ptr(), lists.seg_count.data_ptr(),
               geom.n_seg, geom.n_cols, geom.seg_w, height, width, LOG_TERM,
               acc.data_ptr(), tfin.data_ptr(), lc.data_ptr(), _stream())
    return acc, tfin, lc


def lists_backward(kernel: Kernel, packed: torch.Tensor, lists: SlotLists,
                   geom: ListGeometry, g_acc: torch.Tensor,
                   gtu: torch.Tensor, tfin: torch.Tensor, lc: torch.Tensor):
    """Launch a list backward kernel (K4 or K6). g_acc [4,H,W] = d loss /
    d acc, gtu [H,W] = (d loss / d tfin) * tfin. -> dpacked [N, 10] f32."""
    _check_lists(packed, lists, geom)
    height, width = tfin.shape
    _check(g_acc, "g_acc", torch.float32, (4, height, width))
    _check(gtu, "gtu", torch.float32, (height, width))
    _check(tfin, "tfin", torch.float32, (height, width))
    _check(lc, "lc", torch.int32, (height, width))
    dpacked = torch.zeros((packed.shape[0], NCOL), device=packed.device)
    with torch.cuda.device(packed.device):
        kernel(packed.data_ptr(), lists.order.data_ptr(),
               lists.seg_start.data_ptr(), lists.seg_count.data_ptr(),
               geom.n_seg, geom.n_cols, geom.seg_w, height, width,
               g_acc.data_ptr(), gtu.data_ptr(), tfin.data_ptr(),
               lc.data_ptr(), dpacked.data_ptr(), _stream())
    return dpacked


class _CompositeListsCuda(torch.autograd.Function):
    """packed [N,10] -> (acc [4,H,W], tfin [H,W]) over the lists; the
    forward kernel, and the backward kernel in the backward pass."""

    @staticmethod
    def forward(ctx, packed, lists, geom, height, width, fwd_kernel,
                bwd_kernel):
        packed = packed.contiguous()
        acc, tfin, lc = lists_forward(fwd_kernel, packed, lists, geom,
                                      height, width)
        ctx.save_for_backward(packed, tfin, lc)
        ctx.lists, ctx.geom, ctx.bwd_kernel = lists, geom, bwd_kernel
        return acc, tfin

    @staticmethod
    def backward(ctx, g_acc, g_tfin):
        packed, tfin, lc = ctx.saved_tensors
        dpacked = lists_backward(ctx.bwd_kernel, packed, ctx.lists, ctx.geom,
                                 g_acc.contiguous(),
                                 (g_tfin * tfin).contiguous(), tfin, lc)
        return (dpacked,) + (None,) * 6


# ---- plain version -------------------------------------------------------


def composite_lists_plain(packed: torch.Tensor, lists: SlotLists,
                          geom: ListGeometry, height: int, width: int,
                          chunk: int = 256):
    """The plain version of the list kernels: walks each segment's list
    front to back over the segment's pixels in the plain compositor's
    arithmetic. -> (acc [4,H,W], tfin [H,W], lc [H,W] int64);
    differentiable w.r.t. `packed` through autograd."""
    dev = packed.device
    sr, sw = geom.seg_rows, geom.seg_w
    oy, ox = torch.meshgrid(torch.arange(sr, dtype=torch.float32, device=dev),
                            torch.arange(sw, dtype=torch.float32, device=dev),
                            indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    starts = lists.seg_start.tolist()
    counts = lists.seg_count.tolist()
    rgbds, logTs, lcs = [], [], []
    for s in range(geom.n_seg):
        sy, sx = divmod(s, geom.n_cols)
        idx = lists.order[starts[s]:starts[s] + counts[s]].long()
        rgbd, logT, lc = _scan_chunks(packed[idx], idx, ox + sx * sw,
                                      oy + sy * sr, chunk)
        rgbds.append(rgbd)
        logTs.append(logT)
        lcs.append(lc)

    def image(per_seg, channels):
        # [n_seg, P, C] -> [C, n_rows * sr, n_cols * sw], cropped
        x = torch.stack(per_seg).reshape(geom.n_rows, geom.n_cols, sr, sw,
                                         channels)
        x = x.permute(4, 0, 2, 1, 3).reshape(channels, geom.n_rows * sr,
                                             geom.n_cols * sw)
        return x[:, :height, :width]

    acc = image(rgbds, 4)
    tfin = torch.exp(image([t[:, None] for t in logTs], 1)[0])
    lc = image([t[:, None] for t in lcs], 1)[0]
    return acc, tfin, lc


def composite_lists(packed: torch.Tensor, lists: SlotLists,
                    geom: ListGeometry, height: int, width: int,
                    fwd_kernel: Kernel, bwd_kernel: Kernel):
    """(acc [4,H,W], tfin [H,W]) of a depth-sorted packed [N,10] array over
    its segment lists: the kernels for a CUDA tensor, the plain version for
    a CPU tensor."""
    if packed.is_cuda:
        return _CompositeListsCuda.apply(packed, lists, geom, height, width,
                                         fwd_kernel, bwd_kernel)
    if packed.device.type != "cpu":
        raise ValueError(f"unsupported device {packed.device}")
    acc, tfin, _ = composite_lists_plain(packed, lists, geom, height, width)
    return acc, tfin
