"""Stage 1: geometry initialization, images -> poses + fused point cloud
(port of instantsplat_tpu/pipelines/init_geo_pipeline.py; reference
init_geo.py:24-129):

1. split train/test, load the images (512 long side, /16 crop);
2. build the complete symmetrized pair graph and run the pointmap model
   (MASt3R) over all pairs;
3. global alignment (init/aligner.py): MST init on the host + the
   300-iteration Adam loop on the aligner's device;
4. optional confidence-aware view ranking + co-visibility masks;
5. interpolate test poses from the train trajectory;
6. write the COLMAP-format sparse_{n}/{0,1} scene + sidecars.

The pointmap inference is injected as `pointmap_fn(images, pairs) ->
PairPrediction`, so the pipeline runs with any backend: the MASt3R model
(models/mast3r_infer.make_pointmap_fn) or an exact ("oracle") backend in
tests. With a mesh the alignment is sharded over the ranks (init/aligner.py
align(mesh=)); pass the same mesh to make_pointmap_fn for pair-parallel
inference. Every rank computes the scene; rank 0 alone writes it.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.data import covis, images as image_io, scene as scene_io
from instantsplat_tpu_torch.init import GlobalAligner, make_pair_indices
from instantsplat_tpu_torch.parallel.runtime import is_main_process
from instantsplat_tpu_torch.utils import camera_paths


def run_init_geo(
    source_path,
    model_path,
    pointmap_fn,
    n_views=3,
    image_size=512,
    niter=300,
    lr=0.01,
    schedule="cosine",
    focal_avg=False,
    conf_aware_ranking=False,
    depth_thre=0.01,
    co_vis_dsp=False,
    infer_video=False,
    save_all_pts=False,
    mesh=None,
    max_pts=int(150e10),
    device="cuda",
):
    """Returns the GlobalAligner (with the optimized scene) after writing
    all stage-1 artifacts under <source_path>/sparse_{n_views}/{0,1}. The
    aligner runs on `device`; `aligner.timings` holds the seconds of the
    stage's parts (load, inference, init_mst, align, write)."""
    source_path = Path(source_path)
    model_path = Path(model_path)
    timings = {}
    t_load = time.time()
    writer = is_main_process()
    if writer:
        save_path, sparse_0, sparse_1 = scene_io.init_filestructure(
            source_path, n_views)

    image_files, image_suffix = image_io.sorted_image_files(
        source_path / "images")
    if infer_video:
        train_files, test_files = image_files, []
    else:
        train_files, test_files, _, _ = scene_io.split_train_test(
            image_files, n_views)
    imgs_list, shapes, org_whs = image_io.load_images_mixed(
        train_files, size=image_size)
    mixed = len({tuple(s) for s in shapes}) > 1
    if mixed:
        # mixed-aspect capture: per-image rasters ride a shared (Hmax,
        # Wmax) canvas through the aligner; the pointmap backend
        # dispatches to shape-grouped batched inference
        imgs = imgs_list
        h, w = int(shapes[:, 0].max()), int(shapes[:, 1].max())
    else:
        imgs = np.stack(imgs_list)
        h, w = imgs.shape[1:3]
    org_wh = org_whs[-1]
    timings["load"] = time.time() - t_load

    t0 = time.time()
    pairs = make_pair_indices(len(train_files), "complete", symmetrize=True)
    preds = pointmap_fn(imgs, pairs)
    timings["inference"] = time.time() - t0

    t = time.time()
    aligner = GlobalAligner(preds, device=device)
    aligner.init_mst(focal_avg=focal_avg)
    timings["init_mst"] = time.time() - t
    t = time.time()
    aligner.align(niter=niter, lr=lr, schedule=schedule, mesh=mesh)
    timings["align"] = time.time() - t
    if not writer:
        aligner.timings = timings
        return aligner

    t = time.time()
    extrinsics_w2c = np.linalg.inv(aligner.get_im_poses())
    intrinsics = aligner.get_intrinsics()
    focals = aligner.get_focals()
    pts3d = aligner.get_pts3d()
    confs = aligner.im_conf

    if conf_aware_ranking:
        avg = confs.mean(axis=(1, 2))
        sorted_conf_indices = np.argsort(avg)[::-1]
    else:
        sorted_conf_indices = np.arange(n_views)

    if depth_thre > 0 and not mixed:
        # reference quirk preserved: the raw LOG depth params feed the
        # min-max-normalized depth comparison (init_geo.py:58,74-76)
        overlapping = covis.compute_co_vis_masks(
            sorted_conf_indices, aligner.get_log_depthmaps(), pts3d,
            intrinsics, extrinsics_w2c, imgs.shape[:3],
            depth_threshold=depth_thre)
        keep_masks = ~overlapping
    else:
        if mixed and depth_thre > 0:
            logging.getLogger(__name__).info(
                "co-visibility masking skipped for the mixed-aspect scene "
                "(the cross-projection assumes one raster); padding is "
                "masked instead")
        co_vis_dsp = False
        keep_masks = None
    if mixed:
        # always mask the canvas padding out of the fused point cloud
        keep_masks = aligner.get_valid_masks()
        co_vis_dsp = True
    scene_io.save_time(model_path, "[1] coarse_init_TrainTime",
                       time.time() - t0)

    # test-pose pre-init by interpolation (init_geo.py:86-113)
    if not infer_video and test_files:
        pose_test_init = camera_paths.test_pose_init_from_train(
            extrinsics_w2c, len(test_files))
        scene_io.save_extrinsics(sparse_1, pose_test_init, test_files,
                                 image_suffix)
        # mixed-aspect: test records borrow the FIRST train view's sizes
        scene_io.save_intrinsics(
            sparse_1, np.repeat(focals[0], len(test_files)),
            org_whs[0] if mixed else org_wh,
            tuple(shapes[0]) if mixed else (h, w))

    scene_io.save_time(model_path, "[1] init_geo", time.time() - t0)
    scene_io.save_extrinsics(sparse_0, extrinsics_w2c, train_files,
                             image_suffix)
    scene_io.save_intrinsics(
        sparse_0, np.repeat(focals[0], n_views),
        org_whs if mixed else org_wh,
        [tuple(s) for s in shapes] if mixed else (h, w),
        save_focals=True)
    canvas_imgs = image_io.pad_to_canvas(imgs_list, (h, w)) if mixed else imgs
    scene_io.save_points3d(
        sparse_0, canvas_imgs, pts3d, confs, masks=keep_masks,
        use_masks=co_vis_dsp, save_all_pts=save_all_pts,
        save_txt_path=model_path, depth_threshold=depth_thre,
        max_pts_num=max_pts)
    save_images_and_masks(sparse_0, n_views, imgs_list,
                          None if mixed else keep_masks,
                          train_files, image_suffix)
    timings["write"] = time.time() - t
    aligner.timings = timings
    return aligner


def save_images_and_masks(sparse_0, n_views, imgs, keep_masks, files,
                          suffix):
    """Resized inputs + overlap masks (sfm_utils.py:319-339), each in the
    format of the inputs' suffix."""
    img_dir = Path(sparse_0) / f"imgs_{n_views}"
    mask_dir = Path(sparse_0) / f"overlapping_masks_{n_views}"
    img_dir.mkdir(parents=True, exist_ok=True)
    mask_dir.mkdir(parents=True, exist_ok=True)
    for img, name, mask in zip(
            imgs, files,
            keep_masks if keep_masks is not None else [None] * len(files)):
        stem = Path(name).stem
        image_io.save_image(img_dir / f"{stem}{suffix}", img)
        if mask is not None:
            m = np.repeat((~mask).astype(np.float32)[..., None], 3, -1)
            image_io.save_image(mask_dir / f"{stem}{suffix}", m)
