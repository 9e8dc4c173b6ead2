"""Joint Gaussian + camera-pose optimisation loop (port of
instantsplat_tpu/pipelines/trainer.py::train_joint).

Each iteration renders one training view with its learnable pose, takes
0.8*L1 + 0.2*(1-SSIM) against the ground truth, and applies the grouped
(optionally per-point) Adam step, pose group included. Kept from the JAX
loop: views drawn without replacement per epoch from
np.random.RandomState(seed).permutation (so both packages visit the views
in the same order), the SH ramp every `sh_up_interval` iterations, the
black or white background, the `log_every` history, and resume from an
(opt_state, first_iter) pair. Left out as TPU workarounds: lax.scan
blocks, the dispatch governor, the backend probe and re-probe, the device
mesh and the viewer. Mixed-aspect scenes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import (
    AdamState,
    GaussianOptimizer,
    OptimizationConfig,
)
from instantsplat_tpu_torch.ops.losses import photometric_loss, psnr
from instantsplat_tpu_torch.render.driver import render


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    iterations: int = 1000
    white_background: bool = False
    backend: str = "oracle"
    chunk: int = 256
    sh_up_interval: int = 1000  # reference train.py:148-149
    seed: int = 0
    log_every: int = 100


def train_step(params: GaussianModel, cam: Camera, optimizer, opt_state,
               iteration: int, active_sh: int, bg, lambda_dssim: float,
               backend: str, chunk: int) -> dict:
    """render -> loss -> backward -> Adam, in place. Returns the metrics
    as 0-dim tensors (reading them synchronises with the device)."""
    tensors = params.tensors()
    for t in tensors:
        t.requires_grad_(True)
    out = render(params, cam, pose=params.get_pose(cam.uid), bg=bg,
                 active_sh_degree=active_sh, chunk=chunk, backend=backend)
    loss, aux = photometric_loss(out.render, cam.image, lambda_dssim)
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    for t in tensors:
        t.requires_grad_(False)
    grads = {name: (torch.zeros_like(t) if g is None else g)
             for name, t, g in zip(PARAM_FIELDS, tensors, grads)}
    optimizer.step(params, grads, opt_state, iteration)
    with torch.no_grad():
        aux["psnr"] = psnr(out.render, cam.image)
    return dict(loss=loss.detach(), l1=aux["l1"].detach(),
                ssim=aux["ssim"].detach(), psnr=aux["psnr"])


def train_joint(
    params: GaussianModel,
    cameras: list[Camera],
    opt_cfg: OptimizationConfig = OptimizationConfig(),
    trainer_cfg: TrainerConfig = TrainerConfig(),
    spatial_lr_scale: float = 1.0,
    confidence_lr: Optional[np.ndarray] = None,
    progress_cb: Optional[Callable[[int, dict], None]] = None,
    opt_state: Optional[AdamState] = None,
    first_iter: int = 0,
):
    """Run the joint optimisation; `params` is updated in place.

    Returns (params, opt_state, history), history being a list of
    (iteration, metrics dict) at log_every cadence plus the final step.
    """
    if len({(c.height, c.width) for c in cameras}) > 1:
        raise NotImplementedError(
            "mixed-aspect scenes are not ported yet (ROADMAP.md queue 1)")
    dev = params.xyz.device
    bg = (torch.ones(3, device=dev) if trainer_cfg.white_background
          else torch.zeros(3, device=dev))
    optimizer = GaussianOptimizer(opt_cfg, spatial_lr_scale=spatial_lr_scale,
                                  total_iterations=trainer_cfg.iterations)
    if opt_state is None:
        opt_state = optimizer.init(params, confidence_lr=confidence_lr)

    rng = np.random.RandomState(trainer_cfg.seed)
    queue: list[int] = []
    history = []
    t0 = time.time()
    for it in range(first_iter + 1, trainer_cfg.iterations + 1):
        if not queue:
            queue = list(rng.permutation(len(cameras)))
        view = int(queue.pop())
        active_sh = min(it // trainer_cfg.sh_up_interval,
                        params.max_sh_degree)
        metrics = train_step(params, cameras[view], optimizer, opt_state, it,
                             active_sh, bg, opt_cfg.lambda_dssim,
                             trainer_cfg.backend, trainer_cfg.chunk)
        if it % trainer_cfg.log_every == 0 or it == trainer_cfg.iterations:
            m = {k: float(v) for k, v in metrics.items()}
            m["elapsed_s"] = time.time() - t0
            history.append((it, m))
            if progress_cb is not None:
                progress_cb(it, m)
    return params, opt_state, history
