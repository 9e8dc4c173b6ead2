"""Stage 5: image and pose evaluation of the rendered test sets (port of
instantsplat_tpu/pipelines/metrics_pipeline.py).

For each method directory under <model>/test/: PSNR, SSIM and LPIPS over
the renders-vs-gt pairs (on `device`), and ATE/RPE of the optimised train
poses against the dataset's COLMAP ground truth, written as metrics.txt,
pose_eval.txt, results.json and per_view.json with the JAX stage's keys
and formats (RPE_t x100, RPE_r in degrees). LPIPS is null when no weights
are available (eval/image_metrics.py).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.data import images as image_io, scene as scene_io
from instantsplat_tpu_torch.eval import image_metrics, pose_metrics


def read_render_pairs(method_dir):
    renders_dir = Path(method_dir) / "renders"
    gt_dir = Path(method_dir) / "gt"
    names = sorted(p.name for p in renders_dir.glob("*.png"))
    renders = [image_io.load_image(renders_dir / n) for n in names]
    gts = [image_io.load_image(gt_dir / n) for n in names]
    return renders, gts, names


def evaluate_images(method_dir, lpips_model=None, device="cuda"):
    """-> (summary dict, per-view dict); writes metrics.txt."""
    dev = resolve_device(device)
    renders, gts, names = read_render_pairs(method_dir)
    have_lpips = (lpips_model is not None
                  or image_metrics.default_lpips() is not None)
    ssims, psnrs, lpipss = [], [], []
    with open(Path(method_dir) / "metrics.txt", "w") as out_f:
        for idx, (r, g, name) in enumerate(zip(renders, gts, names)):
            r_t = torch.as_tensor(r, device=dev)
            g_t = torch.as_tensor(g, device=dev)
            with torch.no_grad():
                s = float(image_metrics.ssim(r_t, g_t))
                p = float(image_metrics.psnr(r_t, g_t))
            l = (float(image_metrics.lpips(r_t, g_t, lpips_model))
                 if have_lpips else None)
            ssims.append(s)
            psnrs.append(p)
            lpipss.append(l)
            l_str = f"{l:.4f}" if l is not None else "n/a"
            out_f.write(
                f"image name{name}, image idx: {idx}, PSNR: {p:.2f}, "
                f"SSIM: {s:.4f}, LPIPS: {l_str}\n")
    summary = {
        "SSIM": float(np.mean(ssims)) if ssims else None,
        "PSNR": float(np.mean(psnrs)) if psnrs else None,
        "LPIPS": (float(np.mean(lpipss)) if have_lpips and lpipss
                  else None),
    }
    per_view = {
        "SSIM": dict(zip(names, ssims)),
        "PSNR": dict(zip(names, psnrs)),
        "LPIPS": dict(zip(names, lpipss)),
    }
    return summary, per_view


def evaluate_poses_against_colmap(model_path, method, source_path, n_views):
    """The optimised train poses against the dataset's COLMAP ground truth
    (<source>/sparse/0, its train subset by split_train_test).
    pose_optimized.npy holds w2c and the ground truth is c2w, so the
    estimate is inverted."""
    pose_path = Path(model_path) / "pose" / method
    pose_optimized = np.load(pose_path / "pose_optimized.npy")
    est_c2w = np.linalg.inv(pose_optimized)
    gt_c2w_all = scene_io.read_colmap_gt_pose(source_path)
    gt_train, _, _, _ = scene_io.split_train_test(list(gt_c2w_all), n_views)
    gt_c2w = np.stack(gt_train)
    res = pose_metrics.evaluate_pose(est_c2w, gt_c2w)
    with open(pose_path / "pose_eval.txt", "w") as f:
        f.write("RPE_t: {:.04f}, RPE_r: {:.04f}, ATE: {:.04f}".format(
            res["RPE_t"], res["RPE_r"], res["ATE"]))
    try:
        from instantsplat_tpu_torch.eval.pose_viz import plot_pose

        plot_pose(gt_c2w, est_c2w, pose_path / "pose_vis.png")
    except Exception as e:  # noqa: BLE001 - a missing or broken
        # matplotlib must not fail the metrics; the skip is printed
        print(f"[metrics] pose plot skipped: {e}")
    return res


def run_metrics(model_paths, source_path=None, n_views=None,
                lpips_model=None, eval_pose=True, device="cuda"):
    """The whole metrics stage; returns the results dict per scene."""
    dev = resolve_device(device)
    full, per_view_all = {}, {}
    for scene_dir in model_paths:
        scene_dir = str(scene_dir)
        full[scene_dir] = {}
        per_view_all[scene_dir] = {}
        test_dir = Path(scene_dir) / "test"
        if not test_dir.exists():
            print(f"[metrics] no test renders under {scene_dir}")
            continue
        for method_dir in sorted(test_dir.iterdir()):
            if not method_dir.is_dir():
                continue
            method = method_dir.name
            summary, per_view = evaluate_images(method_dir, lpips_model,
                                                device=dev)
            full[scene_dir][method] = summary
            per_view_all[scene_dir][method] = per_view
            if eval_pose and source_path is not None:
                try:
                    res = evaluate_poses_against_colmap(
                        scene_dir, method, source_path, n_views)
                    full[scene_dir][method].update(res)
                except (OSError, ValueError) as e:
                    print(f"[metrics] pose eval skipped: {e}")
        with open(Path(scene_dir) / "results.json", "w") as f:
            json.dump(full[scene_dir], f, indent=True)
        with open(Path(scene_dir) / "per_view.json", "w") as f:
            json.dump(per_view_all[scene_dir], f, indent=True)
    return full
