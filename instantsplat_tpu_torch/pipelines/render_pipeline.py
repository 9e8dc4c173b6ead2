"""Stage 3/4: render train, test and interpolated views from a trained
model (port of instantsplat_tpu/pipelines/render_pipeline.py).

- train branch: the optimised poses (pose_optimized.npy) on the train
  cameras, one render each;
- test branch: test-time pose refinement. The Gaussians are frozen and
  each test camera's [7] pose is refined against a masked L1 (mask =
  render > 0) for 500 Adam steps (lr_T 3e-3, lr_q 1e-3, betas (0.9,
  0.999), weight decay 1e-4, cosine to 1e-4), keeping the pose of the
  lowest loss; then one render per view. Every step is a forward and a
  backward through the compositor (K1/K2 on the card), with the gradient
  going to the pose alone;
- interp branch: the spline trajectory through the optimised poses (10 s
  at 30 fps), rendered to frames; the mp4 needs imageio and is skipped
  with a printed line without it;
- FPS benchmark: 1000 synchronised renders, the mean of the middle 800,
  appended to total_fps.json.

Not ported: the TPU dispatch governor (bounded fori_loop blocks under a
runtime deadline; a TPU workaround that leaves the maths unchanged) and
the multi-device refinement `refine_poses_sharded`. Its single-device path
is the per-view refinement below batched by lax.map, so here every view
runs `make_pose_refiner`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.data import images as image_io, scene as scene_io
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.ops.losses import masked_l1_loss
from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
from instantsplat_tpu_torch.pipelines.trainer import _binned_candidate, _sync
from instantsplat_tpu_torch.render.driver import render
from instantsplat_tpu_torch.utils import camera_paths
from instantsplat_tpu_torch.utils import transforms as T

_log = logging.getLogger(__name__)
# resolve_backend's clock; module-level so tests can substitute a fake one
_clock = time.perf_counter


def _background(white: bool, device) -> torch.Tensor:
    return torch.ones(3, device=device) if white else \
        torch.zeros(3, device=device)


def resolve_backend(params, camera: Camera, pose: torch.Tensor,
                    bg: torch.Tensor, backend: str) -> str:
    """backend 'auto' -> time one warm forward render of the dense kernels
    and of the capacity candidate sized for this view (tiled, else binned;
    pipelines/trainer._binned_candidate) and keep the faster; both are
    exact. Other values pass through."""
    if backend != "auto":
        return backend
    candidates = ["pallas"]
    cand = _binned_candidate(params, camera, pose)
    if cand is not None:
        candidates.append(cand)
    dev = pose.device
    timed = {}
    with torch.no_grad():
        for name in candidates:
            render(params, camera, pose=pose, bg=bg, backend=name)
            _sync(dev)
            t0 = _clock()
            render(params, camera, pose=pose, bg=bg, backend=name)
            _sync(dev)
            timed[name] = _clock() - t0
    pick = min(timed, key=timed.get)
    _log.info("backend auto: %s (%s per forward)", pick,
              ", ".join(f"{c}={timed[c] * 1e3:.1f} ms" for c in timed))
    return pick


def render_view_set(model_path, name, iteration, cameras, poses7, params,
                    backend="pallas", white_background=False,
                    save_gt=True) -> Path:
    """Render views at the given [V, 7] poses into
    <model>/<name>/ours_<iteration>/renders (and gt/)."""
    out_dir = Path(model_path) / name / f"ours_{iteration}"
    (out_dir / "renders").mkdir(parents=True, exist_ok=True)
    if save_gt:
        (out_dir / "gt").mkdir(parents=True, exist_ok=True)
    dev = params.xyz.device
    bg = _background(white_background, dev)
    for idx, cam in enumerate(cameras):
        with torch.no_grad():
            out = render(params, cam, pose=torch.as_tensor(
                np.asarray(poses7[idx], np.float32), device=dev), bg=bg,
                backend=backend)
        image_io.save_image(out_dir / "renders" / f"{idx:05d}.png",
                            np.clip(out.render.cpu().numpy(), 0, 1))
        if save_gt and cam.image is not None:
            image_io.save_image(out_dir / "gt" / f"{idx:05d}.png",
                                cam.image.cpu().numpy())
    return out_dir


def make_pose_refiner(params, camera: Camera, backend="pallas",
                      num_iter=500, lr_t=3e-3, lr_q=1e-3, lr_min=1e-4,
                      weight_decay=1e-4, bg=None):
    """Per-view test-time pose refinement.

    Returns refine(pose0 [7], gt [H, W, 3], intr=None) -> (best_pose [7],
    best_loss 0-dim), both on the device: `num_iter` Adam steps on pose7
    = (qw qx qy qz tx ty tz) with the learning rates [lr_q x4, lr_t x3]
    annealed by lr_min + (lr - lr_min)(1 + cos(pi t / num_iter)) / 2 at
    step t, weight decay added to the gradient (g + wd * pose) before the
    moments, bias correction at t + 1 and eps added outside the square
    root. The objective is the masked L1 with mask = render > 0. The latch
    keeps the pose at which the lowest loss was taken (not the pose that
    step moved to). It stays on the device: no host read per step.
    `intr` = (fx, fy, cx, cy) replaces the camera's intrinsics, so one
    refiner serves every view of a shape. The Gaussians get no gradient;
    the pose is the only leaf.
    """
    dev = params.xyz.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    # per-step learning rates and bias corrections, float32 as in JAX
    t = torch.arange(num_iter, dtype=torch.float32, device=dev)
    cos = (1 + torch.cos(math.pi * t / num_iter)) / 2
    lr = torch.stack([lr_min + (lr_q - lr_min) * cos] * 4
                     + [lr_min + (lr_t - lr_min) * cos] * 3, dim=1)
    bc1 = 1 - torch.pow(torch.tensor(beta1, device=dev), t + 1.0)
    bc2 = 1 - torch.pow(torch.tensor(beta2, device=dev), t + 1.0)

    def refine(pose0, gt, intr=None):
        cam = camera if intr is None else dataclasses.replace(
            camera, fx=intr[0], fy=intr[1], cx=intr[2], cy=intr[3])
        pose = torch.as_tensor(pose0, dtype=torch.float32,
                               device=dev).detach().clone()
        m = torch.zeros_like(pose)
        v = torch.zeros_like(pose)
        best_pose = pose.clone()
        best_loss = torch.tensor(math.inf, device=dev)
        for k in range(num_iter):
            pose.requires_grad_(True)
            out = render(params, cam, pose=pose, bg=bg, backend=backend)
            loss = masked_l1_loss(out.render, gt, out.render.detach() > 0.0)
            (g,) = torch.autograd.grad(loss, [pose])
            with torch.no_grad():
                pose = pose.detach()
                loss = loss.detach()
                g = g + weight_decay * pose
                m = beta1 * m + (1 - beta1) * g
                v = beta2 * v + (1 - beta2) * g * g
                upd = lr[k] * (m / bc1[k]) / (torch.sqrt(v / bc2[k]) + eps)
                best_pose = torch.where(loss < best_loss, pose, best_pose)
                best_loss = torch.minimum(loss, best_loss)
                pose = pose - upd
        return best_pose, best_loss

    return refine


def render_set_optimize(model_path, name, iteration, cameras, poses7, params,
                        backend="pallas", white_background=False,
                        num_iter=500, test_fps=False) -> np.ndarray:
    """Test branch: refine each view's pose, then render it. Returns the
    refined [V, 7] poses."""
    out_dir = Path(model_path) / name / f"ours_{iteration}"
    (out_dir / "renders").mkdir(parents=True, exist_ok=True)
    (out_dir / "gt").mkdir(parents=True, exist_ok=True)
    dev = params.xyz.device
    bg = _background(white_background, dev)

    refined = []
    # one refiner per raster shape; each view's intrinsics are passed in
    refiner_of_shape: dict = {}
    for idx, cam in enumerate(cameras):
        key = (cam.height, cam.width)
        if key not in refiner_of_shape:
            refiner_of_shape[key] = make_pose_refiner(
                params, cam, backend=backend, num_iter=num_iter, bg=bg)
        t0 = time.perf_counter()
        best_pose, best_loss = refiner_of_shape[key](
            poses7[idx], cam.image, intr=(cam.fx, cam.fy, cam.cx, cam.cy))
        refined.append(best_pose.cpu().numpy())
        print(f"[render] pose refinement view {idx + 1}/{len(cameras)}: "
              f"{num_iter} iterations in {time.perf_counter() - t0:.3f} s, "
              f"best masked L1 {float(best_loss):.7g}, pose "
              + " ".join(f"{x:.7g}" for x in refined[-1]), flush=True)

    for idx, cam in enumerate(cameras):
        with torch.no_grad():
            out = render(params, cam, pose=torch.as_tensor(
                refined[idx], device=dev), bg=bg, backend=backend)
        image_io.save_image(out_dir / "renders" / f"{idx:05d}.png",
                            np.clip(out.render.cpu().numpy(), 0, 1))
        image_io.save_image(out_dir / "gt" / f"{idx:05d}.png",
                            cam.image.cpu().numpy())

    if test_fps:
        fps = render_fps(params, cameras[-1], refined[-1], bg, backend)
        with open(Path(model_path) / "total_fps.json", "a") as f:
            json.dump(f"{fps}", f, indent=True)
            f.write("\n")
        print(f">>> FPS = {fps:.1f}")
    return np.stack(refined)


def render_fps(params, cam: Camera, pose7, bg, backend, n=1000) -> float:
    """Renders per second: `n` renders after a warm one, each ended by a
    device synchronisation; the mean time of the middle 80%."""
    dev = params.xyz.device
    pose = torch.as_tensor(pose7, device=dev)
    times = []
    with torch.no_grad():
        for i in range(n + 1):
            t0 = time.perf_counter()
            render(params, cam, pose=pose, bg=bg, backend=backend)
            _sync(dev)
            if i:  # the first one warms up
                times.append(time.perf_counter() - t0)
    times.sort()
    lo, hi = n // 10, n - n // 10
    return 1.0 / (sum(times[lo:hi]) / (hi - lo))


def save_interpolated_poses(model_path, iteration, n_views, seconds=10,
                            fps=30) -> np.ndarray:
    """The spline trajectory through the optimised poses ->
    pose_interpolated.npy, plus the pose plots when matplotlib is
    installed."""
    pdir = Path(model_path) / "pose" / f"ours_{iteration}"
    org = np.load(pdir / "pose_optimized.npy")
    inter = camera_paths.video_path_from_train_poses(
        org, n_views, seconds=seconds, fps=fps)
    np.save(pdir / "pose_interpolated.npy", inter)
    try:
        from instantsplat_tpu_torch.eval.pose_viz import visualize_cameras

        visualize_cameras(org, ["green"] * len(org),
                          pdir / "poses_optimized.png")
        visualize_cameras(inter, ["blue"] * len(inter),
                          pdir / "poses_interpolated.png")
    except Exception as e:  # noqa: BLE001 - a missing or broken
        # matplotlib must not fail the render; the skip is printed
        print(f"[render] pose viz skipped: {e}")
    return inter


def frames_to_video(frame_dir, out_path, fps=30) -> bool:
    """mp4 from the frames with imageio; without an encoder the skip is
    printed and the frames stay on disk."""
    try:
        import imageio

        frames = [imageio.imread(p)
                  for p in sorted(Path(frame_dir).glob("*.png"))]
        imageio.mimwrite(out_path, frames, fps=fps)
        return True
    except Exception as e:  # noqa: BLE001 - no imageio, or no ffmpeg plugin
        print(f"[render] video encode unavailable ({e}); "
              f"frames left in {frame_dir}")
        return False


def run_render(model, iteration=-1, skip_train=False, skip_test=False,
               infer_video=False, optim_test_pose_iter=500, test_fps=True,
               backend="pallas", video_seconds=10, device="cuda") -> int:
    """The whole render stage for a ModelParams `model`; returns the
    iteration rendered."""
    dev = resolve_device(device)
    model_path = Path(model.model_path)
    train_info = scene_io.read_scene(
        model.source_path, model.n_views, split="train",
        images_dir=model.images, device=dev)
    params, iteration = load_trained(model_path, iteration,
                                     sh_degree=model.sh_degree, device=dev)
    backend = resolve_backend(
        params, train_info.cameras[0],
        torch.as_tensor(T.matrix_to_pose_np(train_info.poses_w2c[:1])[0],
                        device=dev),
        _background(model.white_background, dev), backend)

    if not skip_train:
        opt_poses = np.load(
            model_path / "pose" / f"ours_{iteration}" / "pose_optimized.npy")
        render_view_set(model_path, "train", iteration, train_info.cameras,
                        T.matrix_to_pose_np(opt_poses), params,
                        backend=backend,
                        white_background=model.white_background)

    if not skip_test and not infer_video:
        test_info = scene_io.read_scene(
            model.source_path, model.n_views, split="test",
            images_dir=model.images, device=dev)
        render_set_optimize(
            model_path, "test", iteration, test_info.cameras,
            T.matrix_to_pose_np(test_info.poses_w2c), params,
            backend=backend, white_background=model.white_background,
            num_iter=optim_test_pose_iter, test_fps=test_fps)

    if infer_video:
        inter = save_interpolated_poses(model_path, iteration, model.n_views,
                                        seconds=video_seconds)
        cam0 = train_info.cameras[0]
        cams = [dataclasses.replace(cam0, image=None)] * len(inter)
        out_dir = render_view_set(
            model_path, "interp", iteration, cams,
            T.matrix_to_pose_np(inter), params, backend=backend,
            white_background=model.white_background, save_gt=False)
        frames_to_video(out_dir / "renders",
                        model_path / f"interp_{model.n_views}_view.mp4")
    return iteration
