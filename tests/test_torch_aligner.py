"""The port's stage-1 host code and global aligner against the JAX
package's, on the CPU:

- the golden aligner case (scripts/make_goldens.py::build_aligner_case,
  copied in tests/torch_init_cases.py) through the port's aligner matches
  tests/golden/aligner_case.npz at tests/test_golden.py's tolerances
  (poses rtol 1e-4 / atol 1e-5, focals atol 1e-4, loss rtol 1e-4), and
  JAX's aligner on the same inputs;
- `init_mst` alone gives JAX's initial parameters and MST (same host
  code: within 1e-6); a mixed-aspect canvas case through init_mst and
  align; `clean_pointcloud`, `pair_scene_fast` and `mask_sky`;
- `pairs`, `geometry`, `pnp` (same seeds, same poses) and `covis` (equal
  masks) on seeded inputs; the new `utils/transforms` functions within
  1e-6 and `models/camera`'s focal/fov conversions exactly.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.data import covis as jcovis
from instantsplat_tpu.init import aligner as jal
from instantsplat_tpu.init import geometry as jgeo
from instantsplat_tpu.init import pairs as jpairs
from instantsplat_tpu.init import pnp as jpnp
from instantsplat_tpu.models import camera as jcam
from instantsplat_tpu.utils import transforms as jT
from instantsplat_tpu_torch.data import covis
from instantsplat_tpu_torch.init import aligner as al
from instantsplat_tpu_torch.init import geometry as geo
from instantsplat_tpu_torch.init import pairs
from instantsplat_tpu_torch.init import pnp
from instantsplat_tpu_torch.models import camera
from instantsplat_tpu_torch.utils import transforms as T
from torch_init_cases import aligner_case, run_aligner_case

torch.set_num_threads(2)


def _jax_preds(p):
    return jal.PairPrediction(edges=list(p.edges), pred_i=p.pred_i,
                              pred_j=p.pred_j, conf_i=p.conf_i,
                              conf_j=p.conf_j, shapes=p.shapes)


def test_aligner_matches_golden():
    golden = np.load(Path(__file__).parent / "golden" / "aligner_case.npz")
    got = run_aligner_case("cpu")
    np.testing.assert_allclose(got["poses"], golden["poses"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["focals"], golden["focals"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["loss"], golden["loss"], rtol=1e-4,
                               atol=0)


def test_aligner_matches_jax_aligner():
    preds = aligner_case()
    want = jal.GlobalAligner(_jax_preds(preds))
    want.init_mst(focal_avg=True)
    want_loss = want.align(niter=30)
    got = run_aligner_case("cpu")
    np.testing.assert_allclose(got["poses"], want.get_im_poses(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["focals"], want.get_focals(), atol=1e-4)
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-4)


def test_init_mst_matches_jax():
    preds = aligner_case()
    want = jal.GlobalAligner(_jax_preds(preds))
    got = al.GlobalAligner(preds, device="cpu")
    for k in want.params:  # the seeded initial draw
        np.testing.assert_array_equal(got.params[k], want.params[k])
    assert got.init_mst() == want.init_mst()
    for k in want.params:
        np.testing.assert_allclose(got.params[k], want.params[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got.im_conf, want.im_conf)
    assert (got.focals_frozen, got.poses_frozen) == (False, False)


def test_mixed_aspect_canvas_matches_jax():
    """The golden case with view 2 a 16x24 raster at the top-left of the
    24x32 canvas (conf 1.0 outside it): init_mst + 10 iterations, both
    packages."""
    preds = aligner_case()
    preds.shapes = np.array([[24, 32], [24, 32], [16, 24]])
    outside = np.ones((24, 32), bool)
    outside[:16, :24] = False
    for e, (i, j) in enumerate(preds.edges):
        if i == 2:
            preds.conf_i[e][outside] = 1.0
        if j == 2:
            preds.conf_j[e][outside] = 1.0
    want = jal.GlobalAligner(_jax_preds(preds))
    want.init_mst()
    want_loss = want.align(niter=10)
    got = al.GlobalAligner(preds, device="cpu")
    got.init_mst()
    assert got.mixed
    loss = got.align(niter=10)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    np.testing.assert_allclose(got.get_im_poses(), want.get_im_poses(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.get_focals(), want.get_focals(),
                               atol=1e-4)
    np.testing.assert_array_equal(got.get_valid_masks(),
                                  want.get_valid_masks())


def test_clean_pointcloud_and_pair_scene_fast_match_jax():
    preds = aligner_case()
    a = al.GlobalAligner(preds, device="cpu")
    a.init_mst(focal_avg=True)
    args = (a.im_conf, a.get_intrinsics(), np.linalg.inv(a.get_im_poses()),
            a.get_depthmaps(), a.get_pts3d())
    np.testing.assert_array_equal(al.clean_pointcloud(*args),
                                  jal.clean_pointcloud(*args))
    two = al.PairPrediction(
        edges=[(1, 0), (0, 1)], pred_i=preds.pred_i[:2],
        pred_j=preds.pred_j[:2], conf_i=preds.conf_i[:2],
        conf_j=preds.conf_j[:2])
    for g, w in zip(al.pair_scene_fast(two),
                    jal.pair_scene_fast(_jax_preds(two))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    # mask_sky (eval/viz.segment_sky) zeroes what JAX's zeroes, on a copy
    imgs = np.zeros((3, 24, 32, 3), np.float32)
    imgs[:, :6] = [0.2, 0.4, 0.9]
    before = a.im_conf.copy()
    got = a.mask_sky(imgs).im_conf
    np.testing.assert_array_equal(
        got, jal.GlobalAligner(_jax_preds(preds)).mask_sky(imgs).im_conf)
    assert (got[:, :6] == 0).all() and (got[:, 6:] == before[:, 6:]).all()
    np.testing.assert_array_equal(a.im_conf, before)


@pytest.mark.parametrize("graph", ["complete", "swin", "swin-2", "logwin",
                                   "logwin-2", "oneref", "oneref-2"])
@pytest.mark.parametrize("symmetrize", [True, False])
def test_pairs_match_jax(graph, symmetrize):
    for n in (2, 3, 7):
        assert pairs.make_pair_indices(n, graph, symmetrize) == \
            jpairs.make_pair_indices(n, graph, symmetrize)


def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 3))
    y = 1.7 * x @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.3
    w = rng.random(200)
    for g, j in zip(geo.rigid_points_registration(x, y, w),
                    jgeo.rigid_points_registration(x, y, w)):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-6)
    poses = np.stack([np.eye(4)] * 4)
    poses[:, :3, 3] = rng.standard_normal((4, 3))
    for g, j in zip(geo.align_multiple_poses(poses, poses * 1.3),
                    jgeo.align_multiple_poses(poses, poses * 1.3)):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-6)
    pm = np.concatenate([rng.standard_normal((24, 32, 2)),
                         2 + rng.random((24, 32, 1))], -1)
    assert geo.estimate_focal_weiszfeld(pm) == \
        jgeo.estimate_focal_weiszfeld(pm)
    assert geo.estimate_focal_median(pm) == jgeo.estimate_focal_median(pm)
    trf = geo.sRT_to_4x4(1.3, np.eye(3), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(
        trf, jgeo.sRT_to_4x4(1.3, np.eye(3), [1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(geo.geotrf(trf, x), jgeo.geotrf(trf, x))
    v = rng.standard_normal(50).astype(np.float32) * 3
    for fn, jfn in ((geo.signed_log1p, jgeo.signed_log1p),
                    (geo.signed_expm1, jgeo.signed_expm1)):
        np.testing.assert_array_equal(fn(v), jfn(v))
        np.testing.assert_allclose(fn(torch.from_numpy(v)).numpy(),
                                   np.asarray(jfn(jnp.asarray(v))),
                                   rtol=1e-6, atol=1e-6)


def test_pnp_matches_jax():
    rng = np.random.default_rng(1)
    h, w, f = 24, 32, 30.0
    gy, gx = np.mgrid[:h, :w]
    z = 2.0 + rng.random((h, w))
    cam = np.stack([(gx - w / 2) * z / f, (gy - h / 2) * z / f, z], -1)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, :3] *= np.sign(np.linalg.det(c2w[:3, :3]))
    c2w[:3, 3] = [0.3, -0.2, 0.1]
    world = cam @ c2w[:3, :3].T + c2w[:3, 3]
    world[rng.random((h, w)) < 0.2] += 0.5  # outliers
    mask = rng.random((h, w)) < 0.8
    for focal in (f, None):
        got = pnp.fast_pnp(world, focal, mask, niter_pnp=10, seed=4)
        want = jpnp.fast_pnp(world, focal, mask, niter_pnp=10, seed=4)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    px = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64)
    got = pnp.pnp_ransac(world.reshape(-1, 3), px, K, seed=2)
    want = jpnp.pnp_ransac(world.reshape(-1, 3), px, K, seed=2)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g, j, rtol=0, atol=1e-6)


def test_covis_matches_jax():
    preds = aligner_case()
    a = al.GlobalAligner(preds, device="cpu")
    a.init_mst(focal_avg=True)
    w2c = np.linalg.inv(a.get_im_poses())
    args = ([2, 0, 1], a.get_log_depthmaps(), a.get_pts3d(),
            a.get_intrinsics(), w2c, (3, 24, 32))
    for thr in (0.01, 0.1):
        got = covis.compute_co_vis_masks(*args, depth_threshold=thr)
        np.testing.assert_array_equal(
            got, jcovis.compute_co_vis_masks(*args, depth_threshold=thr))
    assert got.any()


def test_transforms_match_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    R = np.array(jT.quat_to_rotmat(jnp.asarray(q)))
    np.testing.assert_allclose(T.rotmat_to_quat(torch.from_numpy(R)).numpy(),
                               np.asarray(jT.rotmat_to_quat(jnp.asarray(R))),
                               rtol=0, atol=1e-6)
    q2 = rng.standard_normal((64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        T.quat_multiply(torch.from_numpy(q), torch.from_numpy(q2)).numpy(),
        np.asarray(jT.quat_multiply(jnp.asarray(q), jnp.asarray(q2))),
        rtol=0, atol=1e-6)
    M = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    M[:, :3, :3] = R
    M[:, :3, 3] = rng.standard_normal((64, 3))
    np.testing.assert_allclose(T.se3_inverse(torch.from_numpy(M)).numpy(),
                               np.asarray(jT.se3_inverse(jnp.asarray(M))),
                               rtol=0, atol=1e-6)
    pts = rng.standard_normal((64, 10, 3)).astype(np.float32)
    np.testing.assert_allclose(
        T.transform_points(torch.from_numpy(M), torch.from_numpy(pts)).numpy(),
        np.asarray(jT.transform_points(jnp.asarray(M), jnp.asarray(pts))),
        rtol=0, atol=1e-6)
    src = rng.standard_normal((100, 3)).astype(np.float32)
    dst = (1.3 * src @ R[0].T + [0.1, 0.2, 0.3]
           + 0.01 * rng.standard_normal((100, 3))).astype(np.float32)
    wts = rng.random(100).astype(np.float32)
    for with_scale in (True, False):
        got = T.umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                        with_scale)
        want = jT.umeyama(jnp.asarray(src), jnp.asarray(dst), with_scale)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-6)
        got = T.weighted_umeyama(torch.from_numpy(src), torch.from_numpy(dst),
                                 torch.from_numpy(wts), with_scale)
        want = jT.weighted_umeyama(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(wts), with_scale)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                       atol=1e-6)


def test_fov_focal_match_jax():
    for fov, px in ((0.9, 512), (1.3, 384.0), (np.float32(0.5), 64)):
        assert camera.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        assert camera.focal2fov(fov * 400, px) == \
            jcam.focal2fov(fov * 400, px)
