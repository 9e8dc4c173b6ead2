"""The port's user tools against the JAX package's, on the CPU:

- the SIBR viewer protocol (a loopback round trip, as
  tests/test_network_gui.py) and the trainer's live viewer: a 5-iteration
  train_joint answers one loopback request with an image within 1/255 of
  render() of the same camera and the same params, and its loss history
  equals a run without the viewer;
- the validation sweep: make_eval_fn's L1/PSNR equal JAX's within 1e-5
  on the same Gaussians; run_training with testing_iterations writes the
  tags and steps of JAX's scalars.jsonl (values at the loss curves'
  rtol 1e-4) and leaves the loss history as it is without the sweep;
- cosine_lr / linear_lr within 1e-7; masked_photometric_loss and
  masked_ssim values and gradients within 1e-5;
- eval/viz: segment_sky bit-equal on seeded images, GlobalAligner.mask_sky
  equal to JAX's im_conf (uniform and mixed-aspect), depthmap_to_pts3d and
  pts3d_to_mesh equal, export_glb and export_ply byte-equal, and cli.demo
  writing JAX's demo glb; a missing matplotlib skips only the preview.
"""

import json
import socket
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.eval import viz as jviz
from instantsplat_tpu.init.aligner import GlobalAligner as jGlobalAligner
from instantsplat_tpu.init.aligner import PairPrediction as jPairPrediction
from instantsplat_tpu.opt.gaussian_opt import OptimizationConfig as JOptConfig
from instantsplat_tpu.pipelines import train_pipeline as jpipe
from instantsplat_tpu.pipelines.config import ModelParams as JModelParams
from instantsplat_tpu.pipelines.trainer import TrainerConfig as JTrainerConfig
from instantsplat_tpu_torch.convert import gaussians_from_numpy, to_numpy
from instantsplat_tpu_torch.data import scene as scene_io
from instantsplat_tpu_torch.eval import viz
from instantsplat_tpu_torch.init.aligner import GlobalAligner
from instantsplat_tpu_torch.models.camera import Camera, fov2focal
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines import train_pipeline as pipe
from instantsplat_tpu_torch.pipelines.config import ModelParams
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.render.driver import render
from instantsplat_tpu_torch.render.network_gui import NetworkGUI
from torch_init_cases import aligner_case
from torch_scenes import receive_image, send_view_request, write_tiny_scene

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

ITERS = 4
TEST_ITERS = [2, 4]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    scene = tmp_path_factory.mktemp("tools") / "scene"
    write_tiny_scene(scene, n_pts=200, hw=(24, 32))
    return scene


def _params(scene):
    info = scene_io.read_scene(scene, 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=2, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    return info, g


# --------------------------------------------------------------------------
# the viewer
# --------------------------------------------------------------------------


def _receive(conn, h, w, result):
    result["img"], result["verify"] = receive_image(conn, h, w)
    conn.close()


def test_viewer_protocol_roundtrip():
    gui = NetworkGUI()
    gui.init("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    h, w = 8, 12
    result = {}

    def client():
        c = socket.create_connection(("127.0.0.1", port), timeout=5)
        send_view_request(c, h, w)
        _receive(c, h, w, result)

    t = threading.Thread(target=client)
    t.start()
    req = None
    for _ in range(100):
        req = gui.poll()
        if req is not None:
            break
        t.join(timeout=0.05)  # wait out the nonblocking-accept race
    assert req is not None
    assert (req.width, req.height) == (w, h) and req.keep_alive
    cam = req.camera("cpu")
    assert (cam.height, cam.width) == (h, w)
    assert cam.pose.device.type == "cpu"
    frame = np.linspace(0, 1, h * w * 3).reshape(h, w, 3)
    gui.send_image(frame, verify="scene/path")
    t.join(timeout=5)
    gui.close()
    assert not t.is_alive()
    assert result["verify"] == "scene/path"
    np.testing.assert_array_equal(
        result["img"], np.clip(frame * 255 + 0.5, 0, 255).astype(np.uint8))


def test_trainer_serves_the_viewer_without_changing_training(tiny):
    """The request is sent before training starts, so iteration 1 answers
    it with the initial params; the loss history equals a run without
    the viewer."""
    info, g = _params(tiny)
    arrays = to_numpy(g)
    cfg = TrainerConfig(iterations=5, backend="oracle", log_every=1)
    opt = OptimizationConfig(pp_optimizer=True, optim_pose=True)
    _, _, plain = train_joint(gaussians_from_numpy(arrays, 2, device="cpu"),
                              info.cameras, opt, cfg,
                              spatial_lr_scale=info.nerf_radius)

    gui = NetworkGUI()
    gui.init("127.0.0.1", 0)
    h, w = 24, 32
    conn = socket.create_connection(
        ("127.0.0.1", gui.listener.getsockname()[1]), timeout=30)
    send_view_request(conn, h, w, info.poses_w2c[1])
    result = {}
    t = threading.Thread(target=_receive, args=(conn, h, w, result))
    t.start()
    try:
        _, _, served = train_joint(
            gaussians_from_numpy(arrays, 2, device="cpu"), info.cameras,
            opt, cfg, spatial_lr_scale=info.nerf_radius, viewer=gui)
    finally:
        t.join(timeout=30)
        gui.close()
    assert not t.is_alive()
    assert result["verify"] == "training"
    assert [it for it, _ in served] == [it for it, _ in plain]
    for (_, a), (_, b) in zip(served, plain):
        assert {k: a[k] for k in a if k != "elapsed_s"} == \
            {k: b[k] for k in b if k != "elapsed_s"}

    w2c = info.poses_w2c[1]
    cam = Camera.create(w2c[:3, :3], w2c[:3, 3], fx=fov2focal(1.0, w),
                        fy=fov2focal(0.8, h), height=h, width=w,
                        device="cpu")
    with torch.no_grad():
        want = render(gaussians_from_numpy(arrays, 2, device="cpu"), cam,
                      backend="oracle").render.numpy()
    diff = np.abs(result["img"] / 255.0 - want)
    assert diff.max() <= 1 / 255, diff.max()


# --------------------------------------------------------------------------
# the validation sweep
# --------------------------------------------------------------------------


def test_make_eval_fn_matches_jax(tiny):
    from instantsplat_tpu.data.scene import read_scene as jread
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    from instantsplat_tpu.utils.logging import make_eval_fn as jmake
    from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
    from instantsplat_tpu_torch.utils.logging import make_eval_fn

    info, g = _params(tiny)
    arrays = to_numpy(g)
    rng = np.random.default_rng(3)
    # learnable poses off the cameras' own, so the sweep's pose is seen
    arrays["cam_poses"] = (arrays["cam_poses"] + 0.01 * rng.normal(
        size=arrays["cam_poses"].shape)).astype(np.float32)
    got = make_eval_fn([gaussians_from_numpy(arrays, 2, device="cpu")],
                       {"train": info.cameras, "test": []},
                       backend="oracle")()
    jp = JG(**{k: jnp.asarray(arrays[k]) for k in PARAM_FIELDS},
            max_sh_degree=2)
    want = jmake([jp], {"train": jread(tiny, 3).cameras, "test": []},
                 backend="oracle")()
    assert got.keys() == want.keys() == {"train"}
    np.testing.assert_allclose(got["train"], want["train"], rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def sweep_runs(tiny, tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    kw = dict(sh_degree=2, source_path=str(tiny), n_views=3)
    opt_kw = dict(pp_optimizer=True, optim_pose=True)
    tr_kw = dict(iterations=ITERS, backend="oracle", log_every=1)
    out = {}
    _, out["jax"] = jpipe.run_training(
        JModelParams(model_path=str(root / "jax"), **kw),
        JOptConfig(**opt_kw), JTrainerConfig(**tr_kw),
        testing_iterations=TEST_ITERS)
    for name, its in (("port", TEST_ITERS), ("port_plain", ())):
        _, out[name] = pipe.run_training(
            ModelParams(model_path=str(root / name), **kw),
            OptimizationConfig(**opt_kw), TrainerConfig(**tr_kw),
            testing_iterations=its, device="cpu")
    out["root"] = root
    return out


def _scalars(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_sweep_writes_jax_scalars(sweep_runs):
    """Within a step the train scalars come in dict order, which differs
    (JAX's scan returns its metrics with sorted keys): compared sorted."""
    def key(r):
        return r["step"], r["tag"]

    got = sorted(_scalars(sweep_runs["root"] / "port" / "scalars.jsonl"),
                 key=key)
    want = sorted(_scalars(sweep_runs["root"] / "jax" / "scalars.jsonl"),
                  key=key)
    assert [key(r) for r in got] == [key(r) for r in want]
    sweep = [key(r) for r in got if "viewpoint" in r["tag"]]
    assert sweep == [(it, f"train/loss_viewpoint-{m}")
                     for it in TEST_ITERS for m in ("l1", "psnr")]
    for a, b in zip(got, want):
        if a["tag"] != "train/elapsed_s":
            assert a["value"] == pytest.approx(b["value"], rel=1e-4), a


def test_sweep_leaves_the_history_unchanged(sweep_runs):
    a, b = sweep_runs["port"], sweep_runs["port_plain"]
    assert [it for it, _ in a] == [it for it, _ in b]
    for (_, ma), (_, mb) in zip(a, b):
        assert {k: v for k, v in ma.items() if k != "elapsed_s"} == \
            {k: v for k, v in mb.items() if k != "elapsed_s"}


# --------------------------------------------------------------------------
# schedules and masked losses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cosine_lr", "linear_lr"])
def test_schedules_match_jax(name):
    from instantsplat_tpu.utils import schedules as js
    from instantsplat_tpu_torch.utils import schedules as ts

    for args in ((0.01, 1e-6, 300), (0.3, 0.0, 1), (1.0, 0.5, 7)):
        f, jf = getattr(ts, name)(*args), getattr(js, name)(*args)
        for step in (0, 1, 2, 5, 150, 299, 300, 400, -3):
            got = f(step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(step)),
                                       rtol=0, atol=1e-7)


@pytest.mark.parametrize("fn", ["masked_photometric_loss", "masked_ssim"])
def test_masked_losses_match_jax(fn):
    from instantsplat_tpu.ops.losses import \
        masked_photometric_loss as j_masked_loss
    from instantsplat_tpu.ops.ssim import masked_ssim as j_masked_ssim
    from instantsplat_tpu_torch.ops.losses import masked_photometric_loss
    from instantsplat_tpu_torch.ops.ssim import masked_ssim

    rng = np.random.default_rng(5)
    pred = rng.random((24, 32, 3)).astype(np.float32)
    gt = rng.random((24, 32, 3)).astype(np.float32)
    mask = rng.random((24, 32)) < 0.6
    if fn == "masked_ssim":
        def jfun(p):
            return j_masked_ssim(p, jnp.asarray(gt), jnp.asarray(mask))

        def tfun(p):
            return masked_ssim(p, torch.as_tensor(gt), torch.as_tensor(mask))
    else:
        def jfun(p):
            return j_masked_loss(p, jnp.asarray(gt), jnp.asarray(mask))[0]

        def tfun(p):
            return masked_photometric_loss(p, torch.as_tensor(gt),
                                           torch.as_tensor(mask))[0]

    jv, jg = jax.jit(jax.value_and_grad(jfun))(jnp.asarray(pred))
    p = torch.as_tensor(pred).requires_grad_()
    tv = tfun(p)
    (tg,) = torch.autograd.grad(tv, p)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(jg)).max() > 1e-5  # a gradient to compare
    # an empty mask divides by 1, not 0
    empty = masked_photometric_loss(torch.as_tensor(pred),
                                    torch.as_tensor(gt),
                                    torch.zeros(24, 32, dtype=bool))[0]
    assert torch.isfinite(empty)


# --------------------------------------------------------------------------
# eval/viz, mask_sky and the demo
# --------------------------------------------------------------------------


def _sky_images():
    """Seeded images: blue sky bands and luminous-gray clouds over noisy
    ground, two comparable sky parts, pure noise, and a uint8 copy."""
    rng = np.random.default_rng(9)
    h, w = 48, 64
    a = rng.random((h, w, 3)).astype(np.float32) * 0.4
    a[:18] = [0.2, 0.4, 0.9] + 0.05 * rng.standard_normal((18, w, 3))
    a[30:36, 5:12] = [0.95, 0.95, 0.97]
    a[40:42, 50:52] = [0.2, 0.4, 0.9]
    b = rng.random((h, w, 3)).astype(np.float32) * 0.3
    b[:16, :28] = [0.7, 0.7, 0.72]
    b[:16, 36:] = [0.2, 0.45, 0.85]
    c = rng.random((h, w, 3)).astype(np.float32)
    return [a, b, c, (a * 255).astype(np.uint8)]


def test_segment_sky_is_bit_equal():
    for k, img in enumerate(_sky_images()):
        got, want = viz.segment_sky(img), jviz.segment_sky(img)
        assert got.dtype == bool and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, want, err_msg=str(k))
        if k < 2:
            assert got[:10, :20].all(), k
        h, s, v = viz._cv_hsv_bgr_quirk((img * 255).astype(np.uint8)
                                        if k < 3 else img)
        for x, y in zip((h, s, v), jviz._cv_hsv_bgr_quirk(
                (img * 255).astype(np.uint8) if k < 3 else img)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_mask_sky_matches_jax(mixed):
    preds = aligner_case()
    jpreds = jPairPrediction(edges=preds.edges, pred_i=preds.pred_i,
                             pred_j=preds.pred_j, conf_i=preds.conf_i,
                             conf_j=preds.conf_j)
    al, jal = GlobalAligner(preds, device="cpu"), jGlobalAligner(jpreds)
    rng = np.random.default_rng(2)
    imgs = [rng.random((al.H, al.W, 3)).astype(np.float32) * 0.3
            for _ in range(al.n_imgs)]
    for im in imgs:
        im[:8] = [0.2, 0.4, 0.9]
    if mixed:  # a raster smaller than the canvas masks its own extent
        imgs[1] = imgs[1][:20, :28]
    before = al.im_conf.copy()
    res, jres = al.mask_sky(imgs), jal.mask_sky(imgs)
    np.testing.assert_array_equal(al.im_conf, before)  # a copy was masked
    np.testing.assert_array_equal(res.im_conf, jres.im_conf)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        assert (res.im_conf[i, :8, :w] == 0).all(), i
        assert (res.im_conf[i, 8:] == before[i, 8:]).all(), i
        assert (res.im_conf[i, :, w:] == before[i, :, w:]).all(), i


def test_depthmap_and_mesh_match_jax():
    rng = np.random.default_rng(4)
    K = np.array([[40.0, 0, 15.5], [0, 42.0, 11.5], [0, 0, 1]])
    depth = 2.0 + rng.random((24, 32))
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c2w[:3, 3] = rng.standard_normal(3)
    for m in (None, c2w):
        np.testing.assert_array_equal(
            viz.depthmap_to_pts3d(depth, K, cam2world=m),
            jviz.depthmap_to_pts3d(depth, K, cam2world=m))
    img = rng.random((6, 7, 3))
    pts = rng.random((6, 7, 3))
    valid = rng.random((6, 7)) < 0.8
    for kw in ({}, {"valid": valid}):
        for got, want in zip(viz.pts3d_to_mesh(img * 255, pts, **kw),
                             jviz.pts3d_to_mesh(img * 255, pts, **kw)):
            np.testing.assert_array_equal(got, want)
    poses = np.tile(np.eye(4), (3, 1, 1))
    poses[:, 0, 3] = [0.0, 1.0, 3.0]
    assert viz.auto_cam_size(poses) == jviz.auto_cam_size(poses)


def _fill(sv, rng):
    pts = rng.standard_normal((200, 3))
    pts[3] = np.nan  # dropped by both
    sv.add_pointcloud(pts, rng.integers(0, 256, (200, 3)),
                      mask=rng.random(200) < 0.9)
    sv.add_pointcloud(rng.standard_normal((5, 3)), color=(1.0, 0.0, 0.0))
    sv.add_rgbd(rng.random((6, 8, 3)), 1 + rng.random((6, 8)))
    v, f, c = viz.pts3d_to_mesh(rng.random((4, 5, 3)),
                                rng.random((4, 5, 3)))
    sv.add_mesh(v, f, c)
    poses = np.tile(np.eye(4), (2, 1, 1))
    poses[1, :3, 3] = [0.5, 0.1, -0.2]
    sv.add_cameras(poses, focals=[30.0, None], imsizes=[(32, 24), (16, 12)],
                   cam_size=0.1)
    return sv


def test_exports_are_byte_equal(tmp_path):
    got = _fill(viz.SceneViz(), np.random.default_rng(6))
    want = _fill(jviz.SceneViz(), np.random.default_rng(6))
    got.export_glb(tmp_path / "a.glb")
    want.export_glb(tmp_path / "b.glb")
    assert (tmp_path / "a.glb").read_bytes() == \
        (tmp_path / "b.glb").read_bytes()
    got.export_ply(tmp_path / "a.ply")
    want.export_ply(tmp_path / "b.ply")
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()
    viz.SceneViz().export_ply(tmp_path / "empty.ply")
    jviz.SceneViz().export_ply(tmp_path / "jempty.ply")
    assert (tmp_path / "empty.ply").read_bytes() == \
        (tmp_path / "jempty.ply").read_bytes()


def _demo_scene(root):
    """tests/test_viz.py's demo scene, written with the port's writers."""
    rng = np.random.default_rng(0)
    n_views, h, w = 3, 24, 32
    sparse0 = root / "sparse_3" / "0"
    sparse0.mkdir(parents=True)
    w2c = np.tile(np.eye(4), (n_views, 1, 1))
    w2c[:, 0, 3] = np.arange(n_views) * 0.2
    files = [f"f_{i:02d}.png" for i in range(n_views)]
    scene_io.save_extrinsics(sparse0, w2c, files, ".png")
    scene_io.save_intrinsics(sparse0, [40.0] * n_views, (w, h), (h, w))
    imgs = rng.random((n_views, h, w, 3)).astype(np.float32)
    pts = rng.random((n_views, h, w, 3)).astype(np.float32) + [0, 0, 2]
    confs = np.ones((n_views, h, w), np.float32)
    scene_io.save_points3d(sparse0, imgs, pts, confs, use_masks=False,
                           depth_threshold=0.0)


def test_demo_writes_jax_glb(tmp_path, monkeypatch, capsys):
    from instantsplat_tpu.cli.demo import main as jdemo
    from instantsplat_tpu_torch.cli import demo

    _demo_scene(tmp_path / "scene")
    src = str(tmp_path / "scene")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            demo.main(["-s", src, "--outdir", str(tmp_path / "x")])
    jout = jdemo(["-s", src, "--outdir", str(tmp_path / "jax")])
    out = demo.main(["-s", src, "--outdir", str(tmp_path / "port"),
                     "--device", "cpu"])
    for f in ("scene.glb", "scene.ply", "preview.png"):
        assert (out / f).is_file(), f
    for f in ("scene.glb", "scene.ply"):
        assert (out / f).read_bytes() == (jout / f).read_bytes(), f
    # without matplotlib only the preview is skipped, with a printed line
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = demo.main(["-s", src, "--outdir", str(tmp_path / "nompl"),
                     "--device", "cpu"])
    assert "preview skipped" in capsys.readouterr().out
    assert (out / "scene.glb").read_bytes() == (jout / "scene.glb").read_bytes()
    assert (out / "scene.ply").is_file() and not (out / "preview.png").exists()
    with pytest.raises(SystemExit, match="ckpt_path"):
        demo.main(["-s", str(tmp_path / "none"), "--device", "cpu"])
