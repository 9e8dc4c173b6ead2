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

With a mesh (`cli.render --n_devices`), `refine_poses_sharded` splits the
test views over the ranks, each running `make_pose_refiner` on its share,
and gathers the refined poses in view order; rank 0 renders and writes.
Without one every view runs `make_pose_refiner` in turn (JAX batches them
with lax.map on one device, the same per-view maths). The refiner's steps
run as JAX's fori_loop does, on the device: on a card, replays of one
captured CUDA graph (utils/cuda_graphs.StepLoop). Not ported: the TPU
dispatch governor (bounded fori_loop blocks under a runtime deadline; a
TPU workaround that leaves the maths unchanged).
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
from instantsplat_tpu_torch.parallel import runtime
from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
from instantsplat_tpu_torch.pipelines.trainer import (_binned_candidate,
                                                      _is_capacity_backend,
                                                      _sync)
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import render
from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop
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

    As JAX's fori_loop, the steps run on the device: the step works on
    tensors made once (pose, moments, latch, gt, intr, a step counter
    indexing the rate and bias-correction tables), so on a card one step
    is captured into a CUDA graph and replayed num_iter times a view
    (utils/cuda_graphs.StepLoop; the first view's first steps run
    eagerly), and best_pose / best_loss are read once a view. On the CPU
    the same step runs in a Python loop.
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
    # the loop's tensors: what a captured step reads and writes
    pose, m, v, best_pose = (torch.zeros(7, device=dev) for _ in range(4))
    best_loss = torch.zeros((), device=dev)
    gt_s = torch.zeros((camera.height, camera.width, 3), device=dev)
    intr_s = torch.zeros(4, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)
    cam = dataclasses.replace(camera, fx=intr_s[0], fy=intr_s[1],
                              cx=intr_s[2], cy=intr_s[3])

    def step():
        pose.requires_grad_(True)
        out = render(params, cam, pose=pose, bg=bg, backend=backend)
        loss = masked_l1_loss(out.render, gt_s, out.render.detach() > 0.0)
        (g,) = torch.autograd.grad(loss, [pose])
        pose.requires_grad_(False)
        with torch.no_grad():
            loss = loss.detach()
            g = g + weight_decay * pose
            m.copy_(beta1 * m + (1 - beta1) * g)
            v.copy_(beta2 * v + (1 - beta2) * g * g)
            lr_k = lr.index_select(0, k)[0]
            upd = lr_k * (m / bc1.index_select(0, k)) / (
                torch.sqrt(v / bc2.index_select(0, k)) + eps)
            best_pose.copy_(torch.where(loss < best_loss, pose, best_pose))
            best_loss.copy_(torch.minimum(loss, best_loss))
            pose.sub_(upd)
            k.add_(1)

    loops: dict = {}  # the demoted capacity signatures it runs under -> loop
    pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None

    def refine(pose0, gt, intr=None):
        key = _is_capacity_backend(backend) and frozenset(
            driver._guard.demoted)
        if key not in loops:
            loops.clear()
            loops[key] = StepLoop(step, dev, "make_pose_refiner", pool)
        if intr is None:
            intr = (camera.fx, camera.fy, camera.cx, camera.cy)
        with torch.no_grad():
            pose.copy_(torch.as_tensor(pose0, dtype=torch.float32))
            best_pose.copy_(pose)
            m.zero_()
            v.zero_()
            best_loss.fill_(math.inf)
            gt_s.copy_(torch.as_tensor(gt, dtype=torch.float32))
            intr_s.copy_(torch.stack([torch.as_tensor(
                x, dtype=torch.float32, device=dev) for x in intr]))
            k.zero_()
        loops[key].run(num_iter)
        return best_pose.clone(), best_loss.clone()

    return refine


def refine_poses_sharded(params, camera: Camera, poses0, gts, mesh,
                         backend="pallas", num_iter=500, lr_t=3e-3,
                         lr_q=1e-3, lr_min=1e-4, weight_decay=1e-4, bg=None,
                         intrinsics=None):
    """Test-time pose refinement of V views of one raster shape, the views
    split over the ranks of `mesh` (its first axis; None = all here).

    The views are padded to a multiple of the rank count with copies of
    view 0 (dropped afterwards); rank r refines the contiguous block
    [r * V_pad / n, (r + 1) * V_pad / n) with exactly make_pose_refiner's
    maths, and the results are gathered in view order.
    poses0 [V, 7], gts [V, H, W, 3], intrinsics [V, 4] (fx, fy, cx, cy;
    default: the camera's) -> (best_poses [V, 7], best_loss [V]) numpy,
    the same on every rank."""
    dev = params.xyz.device
    group, rank, ndev = (None, 0, 1) if mesh is None else \
        runtime.axis(mesh)
    poses0 = torch.as_tensor(np.asarray(poses0, np.float32), device=dev)
    gts = torch.as_tensor(gts, dtype=torch.float32, device=dev)
    v = poses0.shape[0]
    if intrinsics is None:
        intrinsics = torch.stack([camera.fx, camera.fy, camera.cx,
                                  camera.cy])[None].expand(v, 4)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                 device=dev)
    per = -(-v // ndev)
    pad = per * ndev - v
    if pad:  # copies of view 0, discarded after
        poses0 = torch.cat([poses0, poses0[:1].expand(pad, 7)])
        gts = torch.cat([gts, gts[:1].expand(pad, *gts.shape[1:])])
        intrinsics = torch.cat([intrinsics, intrinsics[:1].expand(pad, 4)])
    refine = make_pose_refiner(params, camera, backend=backend,
                               num_iter=num_iter, lr_t=lr_t, lr_q=lr_q,
                               lr_min=lr_min, weight_decay=weight_decay,
                               bg=bg)
    mine = []
    for k in range(rank * per, (rank + 1) * per):
        best_pose, best_loss = refine(poses0[k], gts[k], intr=tuple(
            intrinsics[k]))
        mine.append(torch.cat([best_pose, best_loss.reshape(1)]))
    out = torch.stack(mine)
    if mesh is not None:
        out = runtime.all_gather_cat(out, group)
    out = out[:v].cpu().numpy()
    return out[:, :7], out[:, 7]


def render_set_optimize(model_path, name, iteration, cameras, poses7, params,
                        backend="pallas", white_background=False,
                        num_iter=500, test_fps=False, mesh=None) -> np.ndarray:
    """Test branch: refine each view's pose, then render it. Returns the
    refined [V, 7] poses. With `mesh` the views of one shape are refined
    in parallel over the ranks (refine_poses_sharded) and rank 0 alone
    renders and writes."""
    out_dir = Path(model_path) / name / f"ours_{iteration}"
    writer = runtime.is_main_process()
    if writer:
        (out_dir / "renders").mkdir(parents=True, exist_ok=True)
        (out_dir / "gt").mkdir(parents=True, exist_ok=True)
    dev = params.xyz.device
    bg = _background(white_background, dev)

    same_shape = len({(c.height, c.width) for c in cameras}) == 1
    if mesh is not None and same_shape and len(cameras) > 1 \
            and num_iter > 0:
        t0 = time.perf_counter()
        best, losses = refine_poses_sharded(
            params, cameras[0], np.asarray(poses7), torch.stack(
                [c.image for c in cameras]), mesh, backend=backend,
            num_iter=num_iter, bg=bg, intrinsics=torch.stack(
                [torch.stack([c.fx, c.fy, c.cx, c.cy]) for c in cameras]))
        if writer:
            print(f"[render] pose refinement of {len(cameras)} views over "
                  f"{mesh.mesh.numel()} devices: {num_iter} iterations in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            for idx in range(len(cameras)):
                print(f"[render] view {idx + 1}/{len(cameras)}: best masked "
                      f"L1 {losses[idx]:.7g}, pose "
                      + " ".join(f"{x:.7g}" for x in best[idx]), flush=True)
        return _render_refined(out_dir, cameras, list(best), params, bg,
                               backend, model_path, test_fps)

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
        if writer:
            print(f"[render] pose refinement view {idx + 1}/{len(cameras)}: "
                  f"{num_iter} iterations in {time.perf_counter() - t0:.3f} "
                  f"s, best masked L1 {float(best_loss):.7g}, pose "
                  + " ".join(f"{x:.7g}" for x in refined[-1]), flush=True)
    return _render_refined(out_dir, cameras, refined, params, bg, backend,
                           model_path, test_fps)


def _render_refined(out_dir, cameras, refined, params, bg, backend,
                    model_path, test_fps) -> np.ndarray:
    """Render and save each test view at its refined pose, and the FPS
    benchmark; on rank 0 only."""
    if not runtime.is_main_process():
        return np.stack(refined)
    dev = params.xyz.device
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
               backend="pallas", video_seconds=10, device="cuda",
               mesh=None) -> int:
    """The whole render stage for a ModelParams `model`; returns the
    iteration rendered. With `mesh` the test views' pose refinement runs
    over the ranks; rank 0 decides the `auto` backend for all of them and
    alone writes the renders."""
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
    if mesh is not None:
        backend = runtime.broadcast_object(backend, runtime.axis(mesh)[0])
    writer = runtime.is_main_process()

    if not skip_train and writer:
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
            num_iter=optim_test_pose_iter, test_fps=test_fps, mesh=mesh)

    if infer_video and writer:
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
