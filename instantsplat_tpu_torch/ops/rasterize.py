"""Plain PyTorch front-to-back compositor (port of instantsplat_tpu/ops/rasterize.py).

The reference per-pixel loop, for each depth-sorted Gaussian:

    alpha = min(0.99, opacity * exp(power)),  power = -1/2 d^T Conic d
    skip if power > 0 or alpha < 1/255
    stop (latched, per pixel) if T * (1 - alpha) < 1e-4
    C += color * alpha * T;  T *= (1 - alpha)

is evaluated as a scan over chunks of splats: an [P, G] falloff block per
chunk, an in-chunk cumulative sum of log(1 - alpha), and a cumulative
`done` latch, so the contributor set equals the sequential loop's. Each
chunk step is wrapped in torch.utils.checkpoint (the JAX version uses
jax.checkpoint), so the backward stores only the per-chunk carries.

This is the CPU path of the dense backend and the version the CUDA
kernels K1/K2 (ops/rasterize_pallas.py) are checked against. Its cost is
O(N * H * W): use it on small scenes, or on the card only for checks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

ALPHA_EPS = 1.0 / 255.0  # minimum contributing alpha
ALPHA_MAX = 0.99  # alpha clamp
LOG_TERM = float(np.log(np.float32(1e-4)))  # float32 log(1e-4), as in JAX


class CompositeOut(NamedTuple):
    rgb: torch.Tensor  # [H, W, 3]
    alpha: torch.Tensor  # [H, W] accumulated opacity (1 - T_final)
    depth: torch.Tensor  # [H, W] alpha-weighted depth (0 where empty)


def pixel_coords(height: int, width: int, device):
    """Pixel-centre coordinates (CUDA convention: centres at integers),
    flattened row-major."""
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def composite_out(acc: torch.Tensor, tfin: torch.Tensor,
                  bg: Optional[torch.Tensor] = None) -> CompositeOut:
    """Image, alpha and depth from the accumulators acc [4, H, W] and the
    final transmittance tfin [H, W]; the background shows through tfin."""
    rgb = acc[:3].permute(1, 2, 0)
    if bg is not None:
        rgb = rgb + tfin[:, :, None] * bg
    return CompositeOut(rgb=rgb, alpha=1.0 - tfin, depth=acc[3])


def _chunk_step(rgbd, logT, done, lc, blk, px, py, base: int):
    """One chunk of the scan. blk [G, 10] packed splats (mx, my, ca, cb, cc,
    log_op, r, g, b, depth); carries rgbd [P, 4], logT [P], done [P] bool,
    lc [P] int (last contributing global index, -1 = none)."""
    dx = px[:, None] - blk[None, :, 0]
    dy = py[:, None] - blk[None, :, 1]
    power = (-0.5 * (blk[None, :, 2] * dx * dx + blk[None, :, 4] * dy * dy)
             - blk[None, :, 3] * dx * dy)
    # minimum, not clamp: JAX's tie gradient (half to each side)
    alpha = torch.minimum(torch.exp(power + blk[None, :, 5]),
                          blk.new_tensor(ALPHA_MAX))
    alpha = torch.where((power > 0) | (alpha < ALPHA_EPS),
                        torch.zeros_like(alpha), alpha)
    l = torch.log1p(-alpha)  # 0 where alpha == 0
    logT_post = logT[:, None] + torch.cumsum(l, dim=1)
    fired = (alpha > 0) & (logT_post < LOG_TERM)
    done_seq = done[:, None] | (torch.cumsum(fired.int(), dim=1) > 0)
    contribute = (alpha > 0) & ~done_seq
    # T before splat j: pre-latch, the non-contributing j' < j have l = 0
    w = torch.where(contribute, alpha * torch.exp(logT_post - l),
                    torch.zeros_like(alpha))
    rgbd = rgbd + w @ blk[:, 6:10]
    logT = logT + torch.sum(torch.where(contribute, l, torch.zeros_like(l)),
                            dim=1)
    gidx = base + torch.arange(blk.shape[0], device=blk.device)
    lc = torch.maximum(lc, torch.max(
        torch.where(contribute, gidx, torch.full_like(gidx, -1)), dim=1
    ).values)
    return rgbd, logT, done_seq[:, -1], lc


def composite_plain(packed: torch.Tensor, height: int, width: int,
                    chunk: int = 256):
    """Composite a depth-sorted packed [N, 10] splat array.

    Columns: mx, my, conic a, b, c, log-opacity (-inf = invalid), r, g, b,
    depth. Returns (acc [4, H, W] = rgb + depth accumulators, tfin [H, W]
    final transmittance, lc [H, W] int64 last contributing index or -1).
    Differentiable w.r.t. `packed` through autograd.
    """
    dev = packed.device
    n = packed.shape[0]
    n_pad = -(-n // chunk) * chunk
    if n_pad > n:
        pad = torch.zeros((n_pad - n, packed.shape[1]), dtype=packed.dtype,
                          device=dev)
        pad[:, 5] = -torch.inf
        packed = torch.cat([packed, pad], dim=0)
    px, py = pixel_coords(height, width, dev)
    n_pix = height * width
    rgbd = torch.zeros((n_pix, 4), device=dev)
    logT = torch.zeros((n_pix,), device=dev)
    done = torch.zeros((n_pix,), dtype=torch.bool, device=dev)
    lc = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)
    for base in range(0, n_pad, chunk):
        blk = packed[base:base + chunk]
        if torch.is_grad_enabled() and blk.requires_grad:
            rgbd, logT, done, lc = checkpoint(
                _chunk_step, rgbd, logT, done, lc, blk, px, py, base,
                use_reentrant=False)
        else:
            rgbd, logT, done, lc = _chunk_step(rgbd, logT, done, lc, blk,
                                               px, py, base)
    acc = rgbd.T.reshape(4, height, width)
    return acc, torch.exp(logT).reshape(height, width), lc.reshape(
        height, width)


def composite(mean2d, conic, log_opacity, colors, depth, valid,
              height: int, width: int, bg: Optional[torch.Tensor] = None,
              chunk: int = 256) -> CompositeOut:
    """Composite depth-sorted Gaussians over the full image (the "oracle"
    backend). All per-Gaussian arrays must already be sorted front to back."""
    lo = torch.where(valid, log_opacity,
                     torch.full_like(log_opacity, -torch.inf))
    packed = torch.cat([mean2d, conic, lo[:, None], colors, depth[:, None]],
                       dim=1)
    acc, tfin, _ = composite_plain(packed, height, width, chunk)
    return composite_out(acc, tfin, bg)
