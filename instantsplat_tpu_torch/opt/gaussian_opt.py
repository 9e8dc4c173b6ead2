"""Grouped Adam / per-point Adam for joint Gaussian + pose optimisation
(port of instantsplat_tpu/opt/gaussian_opt.py).

Adam is written out as tensor ops rather than torch.optim.Adam, because the
per-point variant (reference scene/per_point_adam.py) divides by
sqrt(v) + eps and scales the step by sqrt(bc2)/bc1, which torch's Adam does
not. Kept from the reference:

- the group learning rates: xyz scheduled (log-linear), features_dc =
  feature_lr*10, features_rest = feature_lr/20*10, opacity_lr,
  scaling_lr*10, rotation_lr*10, cam_poses scheduled from rotation_lr*0.1
  to rotation_lr*0.001 (zero without optim_pose);
- eps = 1e-15;
- with pp_optimizer: the per-point LR multiplier on xyz from MASt3R
  confidence, and no moment update for a group whose whole gradient is 0;
- the reference's "self-adjusting" per-point LR updates a local that is
  never written back, so it is a no-op here too.

`step` updates parameters and moments IN PLACE (the JAX version returns new
pytrees); the learning rates and bias corrections are computed in float32,
as JAX computes them, so both packages take the same steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.utils.schedules import expon_lr


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    """Reference defaults (arguments/__init__.py OptimizationParams)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    pp_optimizer: bool = False
    optim_pose: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15


def confidence_to_lr(confidence, scale=(1.0, 100.0)) -> torch.Tensor:
    """MASt3R per-point confidence -> per-point LR multiplier
    (1 - sigmoid(conf)) * (hi - lo) + lo."""
    conf = torch.as_tensor(confidence, dtype=torch.float32)
    lo, hi = scale
    return (1.0 - torch.sigmoid(conf)) * (hi - lo) + lo


@dataclasses.dataclass
class AdamState:
    m: dict  # field name -> first moment
    v: dict  # field name -> second moment
    step: int
    per_point_lr: Optional[torch.Tensor]  # [N, 1] or None


class GaussianOptimizer:
    """Per-group (+ optional per-point) Adam over a GaussianModel."""

    def __init__(self, cfg: OptimizationConfig, spatial_lr_scale: float = 1.0,
                 total_iterations: Optional[int] = None):
        self.cfg = cfg
        self.spatial_lr_scale = float(spatial_lr_scale)
        total = (total_iterations if total_iterations is not None
                 else cfg.iterations)
        self.xyz_sched = expon_lr(
            lr_init=cfg.position_lr_init * self.spatial_lr_scale,
            lr_final=cfg.position_lr_final * self.spatial_lr_scale,
            lr_delay_mult=cfg.position_lr_delay_mult,
            max_steps=cfg.position_lr_max_steps)
        self.pose_sched = expon_lr(
            lr_init=cfg.rotation_lr * 0.1,
            lr_final=cfg.rotation_lr * 0.001,
            lr_delay_mult=cfg.position_lr_delay_mult,
            max_steps=total)

    def group_lrs(self, iteration) -> dict:
        cfg = self.cfg
        return dict(
            xyz=self.xyz_sched(iteration),
            features_dc=cfg.feature_lr * 10.0,
            features_rest=cfg.feature_lr / 20.0 * 10.0,
            opacity=cfg.opacity_lr,
            scaling=cfg.scaling_lr * 10.0,
            rotation=cfg.rotation_lr * 10.0,
            cam_poses=self.pose_sched(iteration) if cfg.optim_pose else 0.0,
        )

    def init(self, params: GaussianModel, confidence_lr=None) -> AdamState:
        m = {f: torch.zeros_like(getattr(params, f)) for f in PARAM_FIELDS}
        v = {f: torch.zeros_like(getattr(params, f)) for f in PARAM_FIELDS}
        ppl = None
        if self.cfg.pp_optimizer:
            dev = params.xyz.device
            if confidence_lr is None:
                ppl = torch.ones((params.num_points, 1), device=dev)
            else:
                ppl = torch.tensor(np.asarray(confidence_lr, np.float32),
                                   device=dev).reshape(-1, 1)
        return AdamState(m=m, v=v, step=0, per_point_lr=ppl)

    @torch.no_grad()
    def step(self, params: GaussianModel, grads: dict, state: AdamState,
             iteration: int) -> None:
        """One Adam step, in place on `params` and `state`. grads: field
        name -> gradient tensor (same shape as the parameter)."""
        cfg = self.cfg
        state.step += 1
        # scalar factors in float32 on the host (as JAX computes them), then
        # applied as Python floats holding those float32 values
        f32 = dict(dtype=torch.float32)
        t = torch.tensor(float(state.step), **f32)
        bc1 = 1.0 - torch.tensor(cfg.beta1, **f32) ** t
        bc2 = 1.0 - torch.tensor(cfg.beta2, **f32) ** t
        lrs = self.group_lrs(iteration)
        for name in PARAM_FIELDS:
            p = getattr(params, name)
            g = grads[name]
            m_old, v_old = state.m[name], state.v[name]
            m = cfg.beta1 * m_old + (1 - cfg.beta1) * g
            v = cfg.beta2 * v_old + (1 - cfg.beta2) * g * g
            lr = torch.as_tensor(lrs[name], **f32)
            if cfg.pp_optimizer:
                # whole-tensor zero-grad skip (per_point_adam.py:65-73)
                nonzero = torch.sum(g * g) > 0
                m = torch.where(nonzero, m, m_old)
                v = torch.where(nonzero, v, v_old)
                denom = torch.sqrt(v) + cfg.eps
                step_size = (lr * torch.sqrt(bc2) / bc1).item()
                upd = step_size * m / denom
                if name == "xyz" and state.per_point_lr is not None:
                    # the reference's self-adjusting per-point LR is
                    # discarded every step (never written back): fixed here
                    upd = upd * state.per_point_lr
                p.sub_(upd)
            else:
                # torch.optim.Adam formulation: sqrt(v)/sqrt(bc2) + eps
                denom = torch.sqrt(v) / torch.sqrt(bc2).item() + cfg.eps
                p.sub_((lr / bc1).item() * m / denom)
            m_old.copy_(m)
            v_old.copy_(v)
