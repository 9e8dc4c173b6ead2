"""Stage 2: joint Gaussian + camera-pose training from a sparse_{n} scene
(port of instantsplat_tpu/pipelines/train_pipeline.py).

Reads the COLMAP-format scene, builds the Gaussians from the fused point
cloud (KNN scales), attaches learnable per-view poses, runs
`trainer.train_joint`, and writes the same artifacts as the JAX stage:

  <model>/point_cloud/iteration_{it}/point_cloud.ply   (3DGS ply)
  <model>/pose/ours_{it}/pose_org.npy                  (initial w2c)
  <model>/pose/ours_{it}/pose_optimized.npy            (optimised w2c)
  <model>/cameras.json, <model>/input.ply, <model>/cfg_args,
  <model>/train_time.txt, <model>/scalars.jsonl
  <model>/ckpt/chkpnt{it}.npz                          (checkpoints)

With a mesh every rank trains (parallel/sharding.py) and rank 0 alone
writes the artifacts and the scalar log.

Checkpoints use the JAX stage's npz keys (p_*, m_*, v_*, step,
per_point_lr, max_sh_degree, iteration), so each package resumes from the
other's.

Spans (utils/profiling.py): `train.run` (the whole call), `train.read`
(the scene), `train.joint` (trainer.train_joint), `train.write` (the
artifacts written before and after training); `train.init` and
`train.knn` come from GaussianModel.create_from_pcd.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.data import ply, scene as scene_io
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import (
    AdamState,
    OptimizationConfig,
    confidence_to_lr,
)
from instantsplat_tpu_torch.parallel.runtime import is_main_process
from instantsplat_tpu_torch.pipelines.config import ModelParams, save_cfg_args
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.utils import profiling
from instantsplat_tpu_torch.utils import transforms as T
from instantsplat_tpu_torch.utils.logging import (
    ScalarLogger,
    make_eval_fn,
    training_report,
)


def poses_7_to_w2c(pose7) -> np.ndarray:
    """[V,7] pose vectors -> [V,4,4] float32 w2c matrices."""
    return T.pose_to_matrix_np(torch.as_tensor(pose7).detach().cpu().numpy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path, params: GaussianModel, opt_state: AdamState,
                    iteration: int):
    """Full training state as a flat npz with the JAX stage's keys."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {"iteration": np.asarray(iteration)}
    for name in PARAM_FIELDS:
        flat[f"p_{name}"] = _np(getattr(params, name))
        flat[f"m_{name}"] = _np(opt_state.m[name])
        flat[f"v_{name}"] = _np(opt_state.v[name])
    flat["step"] = np.asarray(opt_state.step, np.int32)
    if opt_state.per_point_lr is not None:
        flat["per_point_lr"] = _np(opt_state.per_point_lr)
    flat["max_sh_degree"] = np.asarray(params.max_sh_degree)
    np.savez(path, **flat)


def load_checkpoint(path, device="cuda"):
    """-> (params, AdamState, iteration), from either package's npz."""
    z = np.load(path)

    def t(key):
        return torch.as_tensor(np.asarray(z[key], np.float32), device=device)

    params = GaussianModel(**{n: t(f"p_{n}") for n in PARAM_FIELDS},
                           max_sh_degree=int(z["max_sh_degree"]))
    state = AdamState(
        m={n: t(f"m_{n}") for n in PARAM_FIELDS},
        v={n: t(f"v_{n}") for n in PARAM_FIELDS},
        step=int(z["step"]),
        per_point_lr=t("per_point_lr") if "per_point_lr" in z else None,
    )
    return params, state, int(z["iteration"])


def _write_cameras_json(model_path: Path, info):
    json_cams = []
    for cid, cam in enumerate(info.cameras):
        c2w = np.linalg.inv(info.poses_w2c[cid])
        json_cams.append({
            "id": cid,
            "img_name": Path(info.image_names[cid]).stem,
            "width": cam.width,
            "height": cam.height,
            "position": c2w[:3, 3].tolist(),
            "rotation": [row.tolist() for row in c2w[:3, :3]],
            "fx": float(cam.fx),
            "fy": float(cam.fy),
        })
    with open(model_path / "cameras.json", "w") as f:
        json.dump(json_cams, f)


@profiling.spanned("train.run")
def run_training(model: ModelParams, opt: OptimizationConfig,
                 trainer: TrainerConfig, save_iterations=None,
                 checkpoint_iterations=(), progress_cb=None,
                 start_checkpoint=None, testing_iterations=(), viewer=None,
                 device="cuda", mesh=None):
    """Returns (params, history). Writes the artifact tree under
    model.model_path (rank 0 only, with `mesh`; trainer.n_devices may
    build the mesh in train_joint). At the logged iterations listed in
    `testing_iterations` the validation sweep renders every train view
    with its learnable pose (scalars `train/loss_viewpoint-{l1,psnr}`);
    `viewer` (a NetworkGUI) is served live during training."""
    dev = resolve_device(device)
    writer = is_main_process()
    model_path = Path(model.model_path)
    if writer:
        model_path.mkdir(parents=True, exist_ok=True)
    save_iterations = sorted(set(
        [trainer.iterations] if save_iterations is None
        else list(save_iterations) + [trainer.iterations]))

    with profiling.annotate("train.read"):
        info = scene_io.read_scene(
            model.source_path, model.n_views, images_dir=model.images,
            resolution_scale=(1.0 if model.resolution in (-1, 1)
                              else float(model.resolution)),
            device=dev)
    cam_poses = GaussianModel.init_cam_poses_from_w2c(info.poses_w2c)
    scale_override = None
    if model.init_scale_from_view_depth:
        from instantsplat_tpu_torch.utils.graphics import scale_from_view_depth

        focals = np.stack([[float(c.fx), float(c.fy)] for c in info.cameras])
        scale_override = scale_from_view_depth(info.points, info.poses_w2c,
                                               focals)
    params = GaussianModel.create_from_pcd(
        info.points, info.colors, cam_poses=cam_poses,
        max_sh_degree=model.sh_degree, scale_override=scale_override,
        device=dev)

    # per-point LR from MASt3R confidence
    confidence_lr = None
    conf_path = (Path(model.source_path) / f"sparse_{model.n_views}" / "0"
                 / "confidence_dsp.npy")
    if opt.pp_optimizer and conf_path.exists():
        conf = np.load(conf_path).reshape(-1)
        if len(conf) == params.num_points:
            confidence_lr = confidence_to_lr(conf).numpy()

    if writer:
        with profiling.annotate("train.write"):
            if Path(info.ply_path).exists():
                shutil.copyfile(info.ply_path, model_path / "input.ply")
            _write_cameras_json(model_path, info)
            for it in save_iterations:
                pdir = model_path / "pose" / f"ours_{it}"
                pdir.mkdir(parents=True, exist_ok=True)
                np.save(pdir / "pose_org.npy",
                        poses_7_to_w2c(params.cam_poses))

    opt_state0, first_iter = None, 0
    if start_checkpoint:
        params, opt_state0, first_iter = load_checkpoint(start_checkpoint,
                                                         device=dev)
        print(f"[train] resumed from {start_checkpoint} "
              f"at iteration {first_iter}")

    logger = ScalarLogger(model_path) if writer else None
    params_ref = [params]
    eval_fn = make_eval_fn(params_ref, {"train": info.cameras},
                           backend=trainer.backend)

    def _cb(it, m):
        if not writer:
            return
        training_report(logger, it, m, testing_iterations=testing_iterations,
                        eval_fn=eval_fn)
        if progress_cb is not None:
            progress_cb(it, m)

    t0 = time.time()
    try:
        with profiling.annotate("train.joint"):
            params, opt_state, history = train_joint(
                params, info.cameras, opt_cfg=opt, trainer_cfg=trainer,
                spatial_lr_scale=info.nerf_radius,
                confidence_lr=confidence_lr, progress_cb=_cb,
                opt_state=opt_state0, first_iter=first_iter,
                live_ref=params_ref, viewer=viewer, mesh=mesh)
    finally:
        if logger is not None:
            logger.close()
    if not writer:
        return params, history
    scene_io.save_time(model_path, "[2] train_joint", time.time() - t0)

    with profiling.annotate("train.write"):
        for it in save_iterations:
            ply.save_gaussian_ply(model_path / "point_cloud"
                                  / f"iteration_{it}" / "point_cloud.ply",
                                  params)
            np.save(model_path / "pose" / f"ours_{it}"
                    / "pose_optimized.npy", poses_7_to_w2c(params.cam_poses))
        for it in checkpoint_iterations:
            save_checkpoint(model_path / "ckpt" / f"chkpnt{it}.npz", params,
                            opt_state, it)
        save_cfg_args(model_path, Namespace(**dataclasses.asdict(model)))
    return params, history


def load_trained(model_path, iteration, sh_degree=3, cam_poses=None,
                 device="cuda"):
    """-> (GaussianModel, iteration) from point_cloud/iteration_*;
    iteration -1 picks the latest."""
    model_path = Path(model_path)
    if iteration == -1:
        iteration = max(int(p.name.split("_")[1])
                        for p in (model_path / "point_cloud").glob(
                            "iteration_*"))
    params = ply.load_gaussian_ply(
        model_path / "point_cloud" / f"iteration_{iteration}"
        / "point_cloud.ply", max_sh_degree=sh_degree, cam_poses=cam_poses,
        device=device)
    return params, iteration
