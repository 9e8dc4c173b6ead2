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
as JAX computes them, so both packages take the same steps. They reach the
update as a device table (`step_scalars`, one row per step), never as host
floats, so a block of steps can be captured in a CUDA graph and replayed
(pipelines/trainer.py::make_train_scan). On CUDA tensors the update is
ops/adam.py's two launches (csrc/adam.cu), with `apply_step_plain`'s bits;
elsewhere it is `apply_step_plain`, PyTorch ops on each group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import adam
from instantsplat_tpu_torch.utils.cuda_graphs import to_device
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

    def step_scalars(self, iterations, first_step: int) -> torch.Tensor:
        """[k, len(PARAM_FIELDS) + 1] float32 on the host: for the Adam
        steps first_step, first_step + 1, ... taken at `iterations`, each
        group's step factor (lr * sqrt(bc2) / bc1 with pp_optimizer, else
        lr / bc1) and sqrt(bc2), computed in float32 as JAX computes them.
        `apply_step` reads one row; a block of steps copies its table to
        the device once, so no scalar is a host value frozen into a
        captured graph."""
        cfg = self.cfg
        f32 = dict(dtype=torch.float32)
        beta1 = torch.tensor(cfg.beta1, **f32)
        beta2 = torch.tensor(cfg.beta2, **f32)
        rows = []
        for j, iteration in enumerate(iterations):
            t = torch.tensor(float(first_step + j), **f32)
            bc1 = 1.0 - beta1 ** t
            sq_bc2 = torch.sqrt(1.0 - beta2 ** t)
            lrs = self.group_lrs(int(iteration))
            factors = [torch.as_tensor(lrs[name], **f32) * sq_bc2 / bc1
                       if cfg.pp_optimizer else
                       torch.as_tensor(lrs[name], **f32) / bc1
                       for name in PARAM_FIELDS]
            rows.append(torch.stack(factors + [sq_bc2]))
        return torch.stack(rows)

    def step(self, params: GaussianModel, grads: dict, state: AdamState,
             iteration: int, *,
             scalars: Optional[torch.Tensor] = None) -> None:
        """One Adam step, in place on `params` and `state`. grads: field
        name -> gradient tensor (same shape as the parameter). scalars:
        this step's row of `step_scalars` on the parameters' device (made
        here when None)."""
        state.step += 1
        if scalars is None:
            scalars = to_device(self.step_scalars([iteration], state.step),
                                params.xyz.device)[0]
        self.apply_step(params, grads, state, scalars)

    @torch.no_grad()
    def apply_step(self, params: GaussianModel, grads: dict,
                   state: AdamState, scalars: torch.Tensor) -> None:
        """The update of `step` from its row of `step_scalars`, a device
        tensor: device work only (no host read, no host scalar), so it can
        be captured. Leaves state.step to the caller. On CUDA tensors
        ops/adam.fused_step, elsewhere apply_step_plain."""
        if adam.serves(params.xyz):
            adam.fused_step(self.cfg, params, grads, state, scalars)
        else:
            self.apply_step_plain(params, grads, state, scalars)

    @torch.no_grad()
    def apply_step_plain(self, params: GaussianModel, grads: dict,
                         state: AdamState, scalars: torch.Tensor) -> None:
        """apply_step as PyTorch ops on each group: the CPU route, and the
        version the fused kernels are held to."""
        cfg = self.cfg
        sq_bc2 = scalars[-1]
        for i, name in enumerate(PARAM_FIELDS):
            p = getattr(params, name)
            g = grads[name]
            m_old, v_old = state.m[name], state.v[name]
            m = cfg.beta1 * m_old + (1 - cfg.beta1) * g
            v = cfg.beta2 * v_old + (1 - cfg.beta2) * g * g
            factor = scalars[i]
            if cfg.pp_optimizer:
                # whole-tensor zero-grad skip (per_point_adam.py:65-73)
                nonzero = torch.sum(g * g) > 0
                m = torch.where(nonzero, m, m_old)
                v = torch.where(nonzero, v, v_old)
                denom = torch.sqrt(v) + cfg.eps
                upd = factor * m / denom
                if name == "xyz" and state.per_point_lr is not None:
                    # the reference's self-adjusting per-point LR is
                    # discarded every step (never written back): fixed here
                    upd = upd * state.per_point_lr
                p.sub_(upd)
            else:
                # torch.optim.Adam formulation: sqrt(v)/sqrt(bc2) + eps
                denom = torch.sqrt(v) / sq_bc2 + cfg.eps
                p.sub_(factor * m / denom)
            m_old.copy_(m)
            v_old.copy_(v)
