"""Photometric losses (port of instantsplat_tpu/ops/losses.py): loss =
(1 - lambda_dssim) * L1 + lambda_dssim * (1 - SSIM) for training, its
masked form, and the masked L1 of test-time pose refinement."""

from __future__ import annotations

import torch

from instantsplat_tpu_torch.ops.ssim import masked_ssim, ssim


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - gt| over the pixels where `mask` is true. A [H, W] mask
    is broadcast over the channels; the denominator is the broadcast
    mask's sum, at least 1."""
    m = mask.to(pred.dtype)
    if m.ndim == pred.ndim - 1:
        m = m[..., None]
    diff = torch.abs(pred - gt) * m
    return torch.sum(diff) / torch.clamp(torch.sum(m.expand(pred.shape)),
                                         min=1.0)


def photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                     lambda_dssim: float = 0.2):
    """-> (loss, {"l1", "ssim"})."""
    l1 = l1_loss(pred, gt)
    s = ssim(pred, gt)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s)
    return loss, {"l1": l1, "ssim": s}


def masked_photometric_loss(pred: torch.Tensor, gt: torch.Tensor,
                            mask: torch.Tensor, lambda_dssim: float = 0.2):
    """photometric_loss over the pixels where `mask` is true ([H, W]).
    -> (loss, {"l1", "ssim"})."""
    l1 = masked_l1_loss(pred, gt, mask)
    s = masked_ssim(pred, gt, mask)
    loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s)
    return loss, {"l1": l1, "ssim": s}


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR over all pixels (images in [0, 1])."""
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.maximum(
        mse, mse.new_full((), 1e-12))))
