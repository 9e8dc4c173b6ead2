"""Photometric losses (port of instantsplat_tpu/ops/losses.py, the parts
stage 2 uses): loss = (1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM)."""

from __future__ import annotations

import torch

from instantsplat_tpu_torch.ops.ssim import ssim


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2):
    """-> (loss, {"l1", "ssim"})."""
    l1 = l1_loss(pred, gt)
    s = ssim(pred, gt)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s)
    return loss, {"l1": l1, "ssim": s}


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over all pixels (images in [0, 1])."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.maximum(mse, mse.new_tensor(1e-12))))
