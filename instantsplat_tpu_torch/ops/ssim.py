"""Differentiable SSIM (port of instantsplat_tpu/ops/ssim.py).

11x11 Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2, zero-padded
'SAME' borders. The separable blur is written
as 11 shifted-slice multiply-adds per axis, as in the JAX version: that
keeps cuDNN's TF32 convolution out of the loss, so the card computes the
loss in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    """1-D normalized Gaussian taps, float32 values as Python floats."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    return tuple(float(v) for v in (g / g.sum()).astype(np.float32))


def _blur_axis(x: torch.Tensor, win, axis: int) -> torch.Tensor:
    """1-D 'SAME' zero-padded blur of [C, H, W] along `axis` (1 or 2)."""
    k = len(win)
    pad = k // 2
    size = x.shape[axis]
    xp = F.pad(x, (pad, pad) if axis == 2 else (0, 0, pad, pad))
    out = None
    for i in range(k):
        term = win[i] * xp.narrow(axis, i, size)
        out = term if out is None else out + term
    return out


def _blur(img: torch.Tensor, win) -> torch.Tensor:
    return _blur_axis(_blur_axis(img, win, 1), win, 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, c1: float = 0.01**2,
         c2: float = 0.03**2) -> torch.Tensor:
    """Mean SSIM of two 3-D images, [H, W, C] (channels last, detected as
    in the JAX version) or [C, H, W]."""
    if img1.ndim != 3:
        raise ValueError(f"expected 3D image, got {tuple(img1.shape)}")
    if img1.shape[-1] in (1, 3) and img1.shape[0] not in (1, 3):
        img1 = img1.permute(2, 0, 1)
        img2 = img2.permute(2, 0, 1)
    win = _gaussian_window(window_size, sigma)
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
