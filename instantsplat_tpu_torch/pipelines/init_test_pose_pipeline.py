"""Alternative stage 3: test-pose initialization by re-running the pointmap
model over train + test images together (port of
instantsplat_tpu/pipelines/init_test_pose_pipeline.py; reference
init_test_pose.py:24-91, scripted off in run_eval.sh:93-101 but part of
the toolset).

All train + test images are aligned with the train focal preset
(`init_mst(known_focal=...)`), the new train cloud is registered onto the
stage-1 cloud (`sparse_{n}/0/points3D_all.npy`) by a similarity, and the
test poses are transported into the stage-1 frame and written to
`sparse_{n}/1`.

Reference quirk kept: the transport scales only the translation column by
the registration scale ([R, s*T]); the rotation applied to the camera
centres is not scaled (init_test_pose.py:76-81).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import images as image_io, scene as scene_io
from instantsplat_tpu_torch.init import GlobalAligner, make_pair_indices
from instantsplat_tpu_torch.init import geometry as G


def run_init_test_pose(
    source_path, model_path, pointmap_fn, n_views=3, image_size=512,
    niter=500, lr=0.01, schedule="cosine", focal_avg=True, device="cuda",
    timings=None,
):
    """Returns the transported test poses [T, 4, 4] (cam-to-world, stage-1
    frame) after writing them and their intrinsics to sparse_{n}/1. The
    aligner runs on `device`. A `timings` dict, when given, receives the
    seconds of the stage's parts (load, inference, init_mst, align,
    write) and, under "scale", the registration scale s."""
    source_path = Path(source_path)
    model_path = Path(model_path)
    timings = {} if timings is None else timings
    t = time.time()
    _, sparse_0, sparse_1 = scene_io.init_filestructure(source_path, n_views)

    image_files, image_suffix = image_io.sorted_image_files(
        source_path / "images")
    train_files, test_files, _, _ = scene_io.split_train_test(
        image_files, n_views)
    all_files = train_files + test_files
    imgs, (h, w), org_wh = image_io.load_images(all_files, size=image_size)
    timings["load"] = time.time() - t

    t0 = time.time()
    pairs = make_pair_indices(len(all_files), "complete", symmetrize=True)
    preds = pointmap_fn(imgs, pairs)
    timings["inference"] = time.time() - t0

    t = time.time()
    train_pts_m1 = np.load(sparse_0 / "points3D_all.npy")
    preset_focal = None
    if focal_avg:
        preset_focal = float(
            np.mean(np.load(sparse_0 / "non_scaled_focals.npy")))

    aligner = GlobalAligner(preds, device=device)
    aligner.init_mst(known_focal=preset_focal, focal_avg=focal_avg)
    timings["init_mst"] = time.time() - t
    t = time.time()
    aligner.align(niter=niter, lr=lr, schedule=schedule)
    timings["align"] = time.time() - t

    t = time.time()
    all_poses = aligner.get_im_poses()  # c2w
    all_pts3d = aligner.get_pts3d()
    train_pts_n1 = all_pts3d[:n_views].reshape(-1, 3)
    test_poses_n1 = all_poses[n_views:]

    s, R, T = G.rigid_points_registration(
        train_pts_n1, np.asarray(train_pts_m1).reshape(-1, 3))
    trf = np.eye(4)
    trf[:3, :3] = R
    trf[:3, 3] = np.asarray(T).ravel() * s  # reference quirk (see docstring)
    test_poses_m1 = trf @ test_poses_n1

    scene_io.save_time(model_path, "[3] init_test_pose", time.time() - t0)
    scene_io.save_extrinsics(
        sparse_1, np.linalg.inv(test_poses_m1), test_files, image_suffix)
    focal = preset_focal if preset_focal is not None else float(
        aligner.get_focals()[0])
    scene_io.save_intrinsics(
        sparse_1, np.repeat(focal, len(test_files)), org_wh, (h, w))
    timings["write"] = time.time() - t
    timings["scale"] = float(s)
    return test_poses_m1
