"""Dense compositor backend: the CUDA kernels K1 (forward) and K2 (backward).

Port of instantsplat_tpu/ops/rasterize_pallas.py. The TPU file holds the
Pallas kernels `_fwd_kernel` (K1) and `_bwd_kernel` (K2); here they are
hand-written CUDA for Hopper in csrc/rasterize.cu (its header note says
what bounds them and how the design answers), bound with ctypes. What the
TPU version needed for its own layout is not carried over: the 128-lane
width padding, the VMEM strips, the bf16-split MXU prefix sums, the
per-strip backward loop.

`composite_tiles_packed` is the entry point. On a CPU tensor it runs the
plain PyTorch version (`composite_plain`, ops/rasterize.py) and its
autograd; on a CUDA tensor it launches K1 and, in the backward, K2 — or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from instantsplat_tpu_torch.ops import cuda_build
from instantsplat_tpu_torch.ops.rasterize import (  # noqa: F401 (re-export)
    ALPHA_EPS,
    LOG_TERM,
    CompositeOut,
    composite_out,
    composite_plain,
)

TILE = 16  # pixels per tile side (csrc/rasterize.cu TILE)
BATCH = 256  # splats per shared-memory batch (csrc/rasterize.cu BATCH)
NCOL = 10
_LOG_ALPHA_EPS = math.log(ALPHA_EPS)
_DEAD = 1 << 30  # rectangle bound no tile index reaches


class Kernel:
    """One CUDA entry point: its ctypes signature and a launch count."""

    def __init__(self, name: str, argtypes):
        self.name = name
        self.argtypes = argtypes
        self.launches = 0  # incremented once per kernel launch

    def __call__(self, *args):
        fn = getattr(cuda_build.load_library("rasterize.cu"), self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        self.launches += 1
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed "
                               f"(cudaError {err})")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K1 = Kernel("k1_forward", [_P, _I, _P, _P, _I, _I, _I, _F, _P, _P, _P, _P])
K2 = Kernel("k2_backward", [_P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P])


def splat_rects(packed: torch.Tensor, height: int, width: int):
    """Per-splat and per-batch tile rectangles [.., 4] int32
    (x_lo, x_hi, y_lo, y_hi), inclusive, in 16-px tile units.

    The extent is the alpha-cutoff radius along the 2-D covariance's major
    axis: alpha >= 1/255 needs 0.5 d^T Conic d <= lo - log(1/255), so
    |d| <= sqrt(2 m lam_max), widened by x1.001 + 1 px as the TPU kernel's
    row bitmap does (rasterize_pallas.py::_row_block_bitmap). Splats that
    can never contribute get an empty rectangle. Batch rectangles are the
    union over each run of BATCH sorted splats.
    """
    mx, my, ca, cb, cc, lo = packed[:, :6].unbind(1)
    det = ca * cc - cb * cb
    ok = (lo > -torch.inf) & (det > 0) & (ca > 0)
    det_c = torch.clamp(det, min=1e-30)
    tr_cov = torch.where(ok, (ca + cc) / det_c, torch.zeros_like(det))
    det_cov = torch.where(ok, 1.0 / det_c, torch.zeros_like(det))
    mid = 0.5 * tr_cov
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det_cov, min=0.0))
    m = torch.clamp(lo - _LOG_ALPHA_EPS, min=0.0)
    r = torch.sqrt(2.0 * m * lam_max) * 1.001 + 1.0
    alive = ok & (m > 0)
    n_tx, n_ty = -(-width // TILE), -(-height // TILE)

    def span(c, n_t):
        t_lo = torch.floor((c - r) / TILE).clamp(-1, n_t).to(torch.int32)
        t_hi = torch.floor((c + r) / TILE).clamp(-1, n_t).to(torch.int32)
        return t_lo.clamp(min=0), t_hi.clamp(max=n_t - 1)

    x_lo, x_hi = span(mx, n_tx)
    y_lo, y_hi = span(my, n_ty)
    alive = alive & (x_lo <= x_hi) & (y_lo <= y_hi)
    dead_lo = torch.full_like(x_lo, _DEAD)
    dead_hi = torch.full_like(x_hi, -1)
    rect = torch.stack([
        torch.where(alive, x_lo, dead_lo), torch.where(alive, x_hi, dead_hi),
        torch.where(alive, y_lo, dead_lo), torch.where(alive, y_hi, dead_hi),
    ], dim=1)
    n = packed.shape[0]
    n_batches = -(-n // BATCH)
    pad = n_batches * BATCH - n
    padded = torch.cat([rect, torch.tensor(
        [[_DEAD, -1, _DEAD, -1]], dtype=torch.int32,
        device=rect.device).expand(pad, 4)]).view(n_batches, BATCH, 4)
    batch = torch.stack([
        padded[:, :, 0].amin(1), padded[:, :, 1].amax(1),
        padded[:, :, 2].amin(1), padded[:, :, 3].amax(1)], dim=1)
    return rect.contiguous(), batch.contiguous()


def _check(t: torch.Tensor, name: str, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def k1_forward(packed: torch.Tensor, splat_rect: torch.Tensor,
               batch_rect: torch.Tensor, height: int, width: int):
    """Launch K1. -> (acc [4,H,W] f32, tfin [H,W] f32, lc [H,W] int32)."""
    n = packed.shape[0]
    _check(packed, "packed", torch.float32, (n, NCOL))
    _check(splat_rect, "splat_rect", torch.int32, (n, 4))
    n_batches = batch_rect.shape[0]
    _check(batch_rect, "batch_rect", torch.int32, (n_batches, 4))
    dev = packed.device
    acc = torch.empty((4, height, width), device=dev)
    tfin = torch.empty((height, width), device=dev)
    lc = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        K1(packed.data_ptr(), n, splat_rect.data_ptr(), batch_rect.data_ptr(),
           n_batches, height, width, LOG_TERM, acc.data_ptr(),
           tfin.data_ptr(), lc.data_ptr(), _stream())
    return acc, tfin, lc


def k2_backward(packed: torch.Tensor, splat_rect: torch.Tensor,
                batch_rect: torch.Tensor, g_acc: torch.Tensor,
                gtu: torch.Tensor, tfin: torch.Tensor, lc: torch.Tensor):
    """Launch K2. g_acc [4,H,W] = d loss / d acc, gtu [H,W] = (d loss /
    d tfin) * tfin. -> dpacked [N, 10] f32."""
    n = packed.shape[0]
    height, width = tfin.shape
    _check(packed, "packed", torch.float32, (n, NCOL))
    _check(splat_rect, "splat_rect", torch.int32, (n, 4))
    _check(batch_rect, "batch_rect", torch.int32, (batch_rect.shape[0], 4))
    _check(g_acc, "g_acc", torch.float32, (4, height, width))
    _check(gtu, "gtu", torch.float32, (height, width))
    _check(tfin, "tfin", torch.float32, (height, width))
    _check(lc, "lc", torch.int32, (height, width))
    dpacked = torch.zeros((n, NCOL), device=packed.device)
    with torch.cuda.device(packed.device):
        K2(packed.data_ptr(), n, splat_rect.data_ptr(), batch_rect.data_ptr(),
           height, width, g_acc.data_ptr(), gtu.data_ptr(), tfin.data_ptr(),
           lc.data_ptr(), dpacked.data_ptr(), _stream())
    return dpacked


class _CompositeCuda(torch.autograd.Function):
    """packed [N,10] -> (acc [4,H,W], tfin [H,W]); K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, packed, height: int, width: int):
        packed = packed.contiguous()
        rect, batch = splat_rects(packed, height, width)
        acc, tfin, lc = k1_forward(packed, rect, batch, height, width)
        ctx.save_for_backward(packed, rect, batch, tfin, lc)
        return acc, tfin

    @staticmethod
    def backward(ctx, g_acc, g_tfin):
        packed, rect, batch, tfin, lc = ctx.saved_tensors
        dpacked = k2_backward(packed, rect, batch, g_acc.contiguous(),
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
