"""Joint Gaussian + camera-pose optimisation loop (port of
instantsplat_tpu/pipelines/trainer.py::train_joint).

Each iteration renders one training view with its learnable pose, takes
0.8*L1 + 0.2*(1-SSIM) against the ground truth, and applies the grouped
(optionally per-point) Adam step, pose group included. Kept from the JAX
loop: views drawn without replacement per epoch from
np.random.RandomState(seed).permutation (so both packages visit the views
in the same order), the SH ramp every `sh_up_interval` iterations, the
black or white background, the `log_every` history, resume from an
(opt_state, first_iter) pair, mixed-aspect scenes (each view rendered at
its own shape), and backend="auto": the timed probe of the dense kernels
against a capacity backend sized for the scene, and its periodic re-probe
(see train_joint). Left out as TPU workarounds: lax.scan blocks (here a
"block" is just a run of iterations on one backend) and the dispatch
governor that kept each scan under a runtime deadline; not ported yet: the
device mesh and the viewer.
"""

from __future__ import annotations

import dataclasses
import logging
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
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled
from instantsplat_tpu_torch.ops.losses import photometric_loss, psnr
from instantsplat_tpu_torch.render.driver import (
    binned_view_requirements,
    render,
    tiled_view_requirements,
)

_log = logging.getLogger(__name__)


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


# backend='auto': refuse binned/tiled above these capacities (list memory
# and build cost scale with cap_factor * N and with the candidate level
# product; extreme requirements mean the scene is dense-kernel territory)
_MAX_BINNED_CAP_FACTOR = 16
_MAX_BINNED_D_LEVELS = 128
_MAX_TILED_LEVEL_PRODUCT = 64  # dy * dx (the candidate sort is O(N*dy*dx))

# Periodic backend re-probe cadence (iterations); module-level so tests can
# shrink it
_REPROBE_EVERY = 250
# A re-probe switches only when the other backend takes below this share
# of the current one's time per iteration
_SWITCH_SHARE = 0.87
# The probe's clock; module-level so tests can substitute a fake one
_clock = time.perf_counter


def _tiled_candidate(params, camera, pose) -> Optional[str]:
    """'pallas-tiled:CF:DY:DX' sized for the CURRENT scene seen from
    `pose`, or None when out of range (huge splats blow the level product;
    huge images blow the int32 tile*splat key space)."""
    n = int(params.xyz.shape[0])
    if rasterize_pallas_tiled.geometry(camera.height, camera.width).n_seg \
            * (n + 1) >= 2**31:
        return None
    cf, dy, dx = tiled_view_requirements(params, pose, camera)
    if cf > _MAX_BINNED_CAP_FACTOR or dy * dx > _MAX_TILED_LEVEL_PRODUCT:
        return None
    return f"pallas-tiled:{cf}:{dy}:{dx}"


def _binned_candidate(params, camera, pose=None) -> Optional[str]:
    """The capacity backend string for backend='auto' whose capacities hold
    every splat of the CURRENT scene state seen from `pose` (default: the
    learnable pose of view 0), or None when the needed capacity is
    unreasonable. Prefers the 2-D tiled backend (tighter culling); falls
    back to the 1-D binned one when the tile levels are out of range
    (giant splats). A failed probe logs a warning and returns None (auto
    then stays dense)."""
    if pose is None:
        pose = params.get_pose(0)
    try:
        cand = _tiled_candidate(params, camera, pose)
        if cand is not None:
            return cand
        cf, dl = binned_view_requirements(params, pose, camera)
        if cf > _MAX_BINNED_CAP_FACTOR or dl > _MAX_BINNED_D_LEVELS:
            return None
        return f"pallas-binned:{cf}:{dl}"
    except Exception as e:  # noqa: BLE001 - auto must never kill training,
        # but a swallowed probe failure forfeits the faster backend, so it
        # is made visible
        _log.warning("backend auto: binned sizing probe failed (%s: %s); "
                     "falling back to dense", type(e).__name__, e)
        return None


def _is_capacity_backend(name: Optional[str]) -> bool:
    return bool(name) and name.startswith(("pallas-binned", "pallas-tiled"))


def _binned_caps_grew(old: str, new: str) -> bool:
    """True when `new`'s capacities exceed `old`'s in any dimension (smaller
    fresh requirements are still drop-free under the larger capacities). A
    kind change (tiled <-> binned) always counts."""
    okind, *ocaps = old.split(":")
    nkind, *ncaps = new.split(":")
    if okind != nkind or len(ocaps) != len(ncaps) or not ocaps:
        return old != new
    return any(int(nc) > int(oc) for oc, nc in zip(ocaps, ncaps))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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

    Iterations run in blocks that end at log boundaries and never cross an
    SH-ramp boundary, as the JAX loop's scan blocks do. With
    backend="auto" on a scene of one image shape, blocks of
    probe = min(10, log_every) iterations come first: blocks 0-1 run the
    dense kernels and blocks 2-3 the capacity candidate (_binned_candidate,
    sized on camera 0); the second block of each is timed and the faster
    backend is kept. Every _REPROBE_EVERY iterations the capacity side is
    re-sized against the live scene (or demoted when it no longer fits),
    one block is timed on each backend, and the loop switches when the
    other takes below _SWITCH_SHARE of the current one's time. The view
    order, iteration numbers and SH ramp are those of a fixed backend.
    Mixed-shape scenes resolve auto to the dense kernels.
    """
    dev = params.xyz.device
    bg = (torch.ones(3, device=dev) if trainer_cfg.white_background
          else torch.zeros(3, device=dev))
    optimizer = GaussianOptimizer(opt_cfg, spatial_lr_scale=spatial_lr_scale,
                                  total_iterations=trainer_cfg.iterations)
    if opt_state is None:
        opt_state = optimizer.init(params, confidence_lr=confidence_lr)

    rng = np.random.RandomState(trainer_cfg.seed)
    queue: list[int] = []

    def next_view() -> int:
        nonlocal queue
        if not queue:
            queue = list(rng.permutation(len(cameras)))
        return int(queue.pop())

    log_every = trainer_cfg.log_every
    mixed_shapes = len({(c.height, c.width) for c in cameras}) > 1
    cur_name = trainer_cfg.backend
    alt_name: Optional[str] = None
    if cur_name == "auto":
        cur_name = "pallas"
        if not mixed_shapes:
            alt_name = _binned_candidate(params, cameras[0])
    probe = max(1, min(10, log_every))
    # None while the first probe runs (blocks of `probe`), then log_every
    block_cap: Optional[int] = None if alt_name is not None else log_every
    per_iter_main = per_cur_probe = 0.0
    next_reprobe = first_iter + 1 + _REPROBE_EVERY
    reprobe_state = 0  # 0 idle, 1 timing current, 2 timing other

    history = []
    t0 = time.time()
    it = first_iter + 1
    block_idx = 0
    while it <= trainer_cfg.iterations:
        interval = trainer_cfg.sh_up_interval
        end = min(trainer_cfg.iterations, ((it - 1) // log_every + 1)
                  * log_every)
        if it // interval < params.max_sh_degree:
            end = min(end, (it // interval + 1) * interval - 1)
        end = min(end, it + (block_cap or probe) - 1)
        name = (alt_name if block_cap is None and block_idx in (2, 3)
                else cur_name)
        if (block_cap is not None and alt_name is not None
                and reprobe_state == 0 and it >= next_reprobe):
            # re-size the capacity side against the live scene before
            # timing: its capacities were sized when it was chosen
            binned_side = ("cur" if _is_capacity_backend(cur_name)
                           else "alt" if _is_capacity_backend(alt_name)
                           else None)
            start_timing = True
            if binned_side is not None:
                fresh = _binned_candidate(params, cameras[0])
                old = cur_name if binned_side == "cur" else alt_name
                if fresh is None:
                    if binned_side == "cur":
                        cur_name, alt_name = alt_name, cur_name
                        name = cur_name
                        print("[train] backend auto: demoting binned at "
                              f"iter {it} — required capacities now "
                              "unreasonable for this scene", flush=True)
                    start_timing = False  # skip this window; retry later
                elif _binned_caps_grew(old, fresh):
                    if binned_side == "cur":
                        cur_name = name = fresh
                    else:
                        alt_name = fresh
                    print(f"[train] backend auto: binned capacities resized "
                          f"{old} -> {fresh} at iter {it}", flush=True)
            if start_timing:
                reprobe_state = 1
            else:
                next_reprobe = it + _REPROBE_EVERY
        if reprobe_state == 2:
            name = alt_name
        timed = (block_cap is None and block_idx in (1, 3)) or reprobe_state
        if timed:
            _sync(dev)
        t_blk = _clock()
        for i in range(it, end + 1):
            view = next_view()
            active_sh = min(i // interval, params.max_sh_degree)
            metrics = train_step(params, cameras[view], optimizer, opt_state,
                                 i, active_sh, bg, opt_cfg.lambda_dssim,
                                 name, trainer_cfg.chunk)
        if timed:
            _sync(dev)
        per_iter = (_clock() - t_blk) / (end - it + 1)
        if reprobe_state == 1:
            per_cur_probe = per_iter
            reprobe_state = 2
        elif reprobe_state == 2:
            if per_iter < _SWITCH_SHARE * per_cur_probe:
                cur_name, alt_name = alt_name, cur_name
                print(f"[train] backend auto: switching at iter {it} — "
                      f"other backend {per_iter * 1e3:.0f} ms/iter beats "
                      f"current {per_cur_probe * 1e3:.0f}", flush=True)
            reprobe_state = 0
            next_reprobe = it + _REPROBE_EVERY
        if block_cap is None and block_idx == 1:
            per_iter_main = per_iter
        if block_cap is None and block_idx == 3:
            if per_iter < per_iter_main:
                cur_name, alt_name = alt_name, cur_name
                win, lose, t_win, t_lose = ("binned", "dense", per_iter,
                                            per_iter_main)
            else:
                win, lose, t_win, t_lose = ("dense", "binned", per_iter_main,
                                            per_iter)
            print(f"[train] backend auto: {win} ({t_win * 1e3:.0f} ms/iter) "
                  f"beats {lose} ({t_lose * 1e3:.0f} ms/iter)", flush=True)
            block_cap = log_every
        block_idx += 1
        if end % log_every == 0 or end == trainer_cfg.iterations:
            m = {k: float(v) for k, v in metrics.items()}
            m["elapsed_s"] = time.time() - t0
            history.append((end, m))
            if progress_cb is not None:
                progress_cb(end, m)
        it = end + 1
    return params, opt_state, history
