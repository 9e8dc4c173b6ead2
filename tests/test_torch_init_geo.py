"""Stage 1 of the port against the JAX package's, on the CPU:

- the writers (`save_extrinsics`, `save_intrinsics`, `save_points3d`) on
  the same inputs write byte-equal files; points3D text and binary read
  across the packages both ways;
- the MASt3R input policy (`load_images`, `load_images_mixed`,
  `sorted_image_files`) gives the same arrays on PNG inputs of 512 long
  side, of other sizes and of mixed aspect; without Pillow a 512 PNG
  still loads and a resize or a non-PNG write raises; `save_image` writes
  the format its suffix names;
- both packages' `run_init_geo` on one oracle scene (tests/
  test_pipeline_e2e.py's 48x64 textured plane, its pointmaps with seeded
  noise, 60 aligner iterations, co-visibility masks, a seeded
  downsample) write the same sparse_3/{0,1} (poses and focals within
  1e-5, clouds within rtol 1e-4 as the golden aligner case, confidences
  equal, images and masks equal pixel for pixel), and each
  package's `read_scene` loads the other's output;
- the port's `cli.train --device cpu` trains 3 iterations on the port's
  output; `cli.init_geo --device cpu` runs (the TINY model) and, without
  a card, raises; its parser takes JAX's flags with JAX's defaults; a
  missing --ckpt_path raises JAX's explanatory error.
"""

import sys

import numpy as np
import pytest
import torch

from instantsplat_tpu.data import colmap as jcolmap
from instantsplat_tpu.data import images as jimages
from instantsplat_tpu.data import scene as jscene
from instantsplat_tpu.init.aligner import PairPrediction as jPairPrediction
from instantsplat_tpu.pipelines import init_geo_pipeline as jpipe
from instantsplat_tpu_torch.cli import init_geo as init_cli
from instantsplat_tpu_torch.data import colmap, images, png, ply, scene
from instantsplat_tpu_torch.init.aligner import PairPrediction
from instantsplat_tpu_torch.models import mast3r, mast3r_infer
from instantsplat_tpu_torch.pipelines import init_geo_pipeline as pipe
from test_pipeline_e2e import H, N_IMAGES, N_VIEWS, W, _scene_geometry
from torch_init_cases import (TINY, oracle_pointmap_fn, scene_geometry,
                              write_oracle_scene)

torch.set_num_threads(2)
NITER = 60
MAX_PTS = 4000  # below the 3 x 48 x 64 pixels: the seeded downsample runs


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(JAX scene dir, port scene dir): the same oracle scene through
    each package's run_init_geo."""
    root = tmp_path_factory.mktemp("init_geo")
    out = {}
    for name in ("jax", "port"):
        files = write_oracle_scene(root / name)
        kw = dict(n_views=N_VIEWS, image_size=max(H, W), niter=NITER,
                  focal_avg=True, conf_aware_ranking=True, co_vis_dsp=True,
                  depth_thre=0.01, save_all_pts=True, max_pts=MAX_PTS)
        np.random.seed(0)  # save_points3d's downsample draws from it
        if name == "jax":
            jpipe.run_init_geo(root / name, root / f"{name}_out",
                               oracle_pointmap_fn(files, jPairPrediction), **kw)
        else:
            al = pipe.run_init_geo(root / name, root / f"{name}_out",
                                   oracle_pointmap_fn(files, PairPrediction),
                                   device="cpu", **kw)
            assert set(al.timings) == {"load", "inference", "init_mst",
                                       "align", "write"}
        out[name] = root / name
    return out


def _sparse(root, sub):
    return root / f"sparse_{N_VIEWS}" / sub


@pytest.mark.parametrize("sub", ["0", "1"])
def test_run_init_geo_writes_jax_sparse(scenes, sub):
    a, b = _sparse(scenes["jax"], sub), _sparse(scenes["port"], sub)
    for reader in (colmap.read_images_text, colmap.read_images_binary):
        ia = reader(a / ("images.txt" if "text" in reader.__name__
                         else "images.bin"))
        ib = reader(b / ("images.txt" if "text" in reader.__name__
                         else "images.bin"))
        assert [im.name for im in ia.values()] == \
            [im.name for im in ib.values()]
        for k in ia:
            np.testing.assert_allclose(ib[k].w2c, ia[k].w2c, rtol=0,
                                       atol=1e-5)
    for reader, f in ((colmap.read_cameras_text, "cameras.txt"),
                      (colmap.read_cameras_binary, "cameras.bin")):
        ca, cb = reader(a / f), reader(b / f)
        assert ca.keys() == cb.keys()
        for k in ca:
            assert (ca[k].model, ca[k].width, ca[k].height) == \
                (cb[k].model, cb[k].width, cb[k].height)
            np.testing.assert_allclose(cb[k].params, ca[k].params,
                                       rtol=1e-5)
    if sub == "1":
        return
    np.testing.assert_allclose(np.load(b / "non_scaled_focals.npy"),
                               np.load(a / "non_scaled_focals.npy"),
                               rtol=1e-5)
    for f in ("confidence.npy", "confidence_dsp.npy", "pointsColor_all.npy"):
        np.testing.assert_array_equal(np.load(b / f), np.load(a / f),
                                      err_msg=f)
    # the clouds are the aligner's depths, poses and focals, held at the
    # golden aligner case's tolerance (tests/test_golden.py: rtol 1e-4)
    pa, pb = np.load(a / "points3D_all.npy"), np.load(b / "points3D_all.npy")
    np.testing.assert_allclose(pb, pa, rtol=1e-4, atol=1e-5)
    (xa, ca), (xb, cb) = (ply.fetch_point_cloud(a / "points3D.ply"),
                          ply.fetch_point_cloud(b / "points3D.ply"))
    assert len(xa) == MAX_PTS
    np.testing.assert_allclose(xb, xa, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(cb, ca)
    for d in (f"imgs_{N_VIEWS}", f"overlapping_masks_{N_VIEWS}"):
        names = sorted(p.name for p in (a / d).iterdir())
        # 14 frames: split_train_test's train views are frames 0, 0, 13
        assert names == sorted(p.name for p in (b / d).iterdir())
        assert names == ["frame_0000.png", "frame_0013.png"]
        for n in names:
            np.testing.assert_array_equal(png.read_png(b / d / n),
                                          png.read_png(a / d / n))
    # the co-visibility masks dropped points of a later view
    assert any(png.read_png(a / f"overlapping_masks_{N_VIEWS}" / n).any()
               for n in names)


def test_oracle_scene_is_the_jax_tests_scene():
    """torch_init_cases' copy of the scene (no JAX, so the card's tests
    use it too) is tests/test_pipeline_e2e.py's, array for array."""
    for got, want in zip(scene_geometry(), _scene_geometry()):
        np.testing.assert_array_equal(got, want)
    assert (H, W, N_IMAGES, N_VIEWS) == (48, 64, 14, 3)


def test_init_geo_focal_near_truth(scenes):
    cams = colmap.read_cameras_text(_sparse(scenes["port"], "0")
                                    / "cameras.txt")
    assert abs(cams[1].params[0] - 50.0) / 50.0 < 0.05


def test_each_package_reads_the_others_scene(scenes):
    for ours, theirs in ((scenes["port"], scenes["jax"]),
                         (scenes["jax"], scenes["port"])):
        t = scene.read_scene(theirs, N_VIEWS, device="cpu")
        j = jscene.read_scene(ours, N_VIEWS)
        o = scene.read_scene(ours, N_VIEWS, device="cpu")
        assert t.image_names == j.image_names == o.image_names
        np.testing.assert_allclose(t.poses_w2c, j.poses_w2c, atol=1e-5)
        np.testing.assert_allclose(o.points, j.points)
        assert len(o.cameras) == N_VIEWS
        for cam in o.cameras:
            assert cam.image.shape == (H, W, 3)


def test_port_trains_on_its_init_geo_output(scenes, tmp_path):
    from instantsplat_tpu_torch.cli import train as train_cli

    params, history = train_cli.main([
        "-s", str(scenes["port"]), "-m", str(tmp_path / "model"),
        "--n_views", str(N_VIEWS), "--iterations", "3", "--log_every", "1",
        "--pp_optimizer", "--optim_pose", "--device", "cpu", "--quiet"])
    assert len(history) == 3
    assert all(np.isfinite(m["loss"]) for _, m in history)
    assert (tmp_path / "model" / "point_cloud" / "iteration_3"
            / "point_cloud.ply").is_file()


# --------------------------------------------------------------------------
# writers and readers
# --------------------------------------------------------------------------


def _w2c(rng, n):
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * np.sign(np.linalg.det(q))
        m[:3, 3] = rng.standard_normal(3)
        out.append(m)
    return np.stack(out)


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_writers_are_byte_equal(tmp_path, mixed):
    rng = np.random.default_rng(0)
    files = [f"im{k}.png" for k in range(3)]
    w2c = _w2c(rng, 3)
    focals = rng.uniform(200, 400, 3)
    org = [(640, 480), (480, 640), (640, 480)] if mixed else (640, 480)
    hw = [(384, 512), (512, 384), (384, 512)] if mixed else (384, 512)
    v, h, w = 3, 12, 16
    imgs = rng.random((v, h, w, 3)).astype(np.float32)
    pts = rng.standard_normal((v, h, w, 3)).astype(np.float32)
    confs = 1 + rng.random((v, h, w)).astype(np.float32)
    masks = rng.random((v, h, w)) < 0.7
    for pkg, d in ((scene, tmp_path / "port"), (jscene, tmp_path / "jax")):
        d.mkdir()
        pkg.save_extrinsics(d, w2c, files, ".png")
        pkg.save_intrinsics(d, focals, org, hw, save_focals=True)
        np.random.seed(3)
        n = pkg.save_points3d(d, imgs, pts, confs, masks=masks,
                              save_all_pts=True, save_txt_path=d,
                              max_pts_num=200)
        assert n == 200
    for f in ("images.txt", "images.bin", "cameras.txt", "cameras.bin",
              "non_scaled_focals.npy", "points3D.ply", "confidence.npy",
              "confidence_dsp.npy", "points3D_all.npy",
              "pointsColor_all.npy", "pts_num.txt"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    for pkg in (scene, jscene):
        d = pkg.init_filestructure(tmp_path / "fs", 3)[1]
        assert d == tmp_path / "fs" / "sparse_3" / "0" and d.is_dir()


def test_points3d_files_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.standard_normal((20, 3))
    rgb = rng.integers(0, 256, (20, 3))
    err = rng.random(20)
    for w_mod, r_mod in ((colmap, jcolmap), (jcolmap, colmap)):
        for kind in ("text", "binary"):
            path = tmp_path / f"{w_mod.__name__}.{kind}"
            getattr(w_mod, f"write_points3d_{kind}")(path, xyz, rgb, err)
            x, c, e = getattr(r_mod, f"read_points3d_{kind}")(path)
            np.testing.assert_allclose(x, xyz, rtol=1e-15)
            np.testing.assert_array_equal(c, rgb)
            np.testing.assert_allclose(e.ravel(), err, rtol=1e-15)


# --------------------------------------------------------------------------
# the MASt3R input policy
# --------------------------------------------------------------------------


def _png(path, w, h, seed):
    rng = np.random.default_rng(seed)
    png.write_png(path, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("wh", [(512, 384), (384, 512), (512, 512),
                                (520, 390), (300, 200), (501, 333)],
                         ids=lambda wh: f"{wh[0]}x{wh[1]}")
def test_load_images_matches_jax(tmp_path, wh):
    for k in range(2):
        _png(tmp_path / f"{k:02d}.png", *wh, seed=k)
    files, suffix = images.sorted_image_files(tmp_path)
    assert (files, suffix) == jimages.sorted_image_files(tmp_path)
    got = images.load_images(files, size=512)
    want = jimages.load_images(files, size=512)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32
    assert tuple(got[1]) == tuple(want[1]) and got[2] == want[2]
    assert got[0].shape[1] % 16 == 0 and got[0].shape[2] % 16 == 0


def test_load_images_mixed_matches_jax(tmp_path):
    for k, wh in enumerate([(512, 384), (384, 512), (640, 480)]):
        _png(tmp_path / f"img{k}.png", *wh, seed=k)
    files, _ = images.sorted_image_files(tmp_path)
    got = images.load_images_mixed(files)
    want = jimages.load_images_mixed(files)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    with pytest.raises(ValueError, match="load_images_mixed"):
        images.load_images(files)
    canvas = images.pad_to_canvas(got[0], fill=0.5)
    np.testing.assert_array_equal(
        canvas, jimages.pad_to_canvas(want[0], fill=0.5))


def test_without_pillow(tmp_path, monkeypatch):
    _png(tmp_path / "a.png", 512, 384, 0)
    _png(tmp_path / "b.png", 300, 200, 1)
    want = jimages.load_images([tmp_path / "a.png"])[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(
        images.load_images([tmp_path / "a.png"])[0], want)
    with pytest.raises(RuntimeError, match="needs Pillow"):
        images.load_images([tmp_path / "b.png"])
    with pytest.raises(RuntimeError, match="needs Pillow"):
        images.save_image(tmp_path / "c.jpg", want[0])
    images.save_image(tmp_path / "c.png", want[0])


def test_save_image_writes_the_suffix_format(tmp_path):
    img = np.random.default_rng(2).random((16, 24, 3))
    images.save_image(tmp_path / "x.jpg", img)
    images.save_image(tmp_path / "x.png", img)
    assert (tmp_path / "x.jpg").read_bytes()[:2] == b"\xff\xd8"
    assert (tmp_path / "x.png").read_bytes()[:4] == b"\x89PNG"
    jimages.save_image(tmp_path / "j.jpg", img)
    assert (tmp_path / "x.jpg").read_bytes() == \
        (tmp_path / "j.jpg").read_bytes()


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_parser_takes_jax_flags_with_jax_defaults():
    from instantsplat_tpu.cli import init_geo as jcli

    ours, theirs = init_cli.build_parser(), jcli.build_parser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type)
                for a in p._actions if a.dest != "help"}

    f_ours, f_theirs = flags(ours), flags(theirs)
    assert f_ours.keys() == f_theirs.keys()
    for k in f_theirs:
        if k != "device":
            assert f_ours[k] == f_theirs[k], k
    argv = ["-s", "a", "-m", "b", "--focal_avg", "--co_vis_dsp",
            "--conf_aware_ranking", "--ckpt_path", "random:0"]
    a, b = vars(ours.parse_args(argv)), vars(theirs.parse_args(argv))
    assert a.pop("device") == "cuda" and b.pop("device") == "tpu"
    assert a == b
    assert a["dtype"] == "bf16" and a["batch_size"] == 24


def test_missing_ckpt_raises_jax_error():
    from instantsplat_tpu.models import mast3r_infer as jinfer

    with pytest.raises(RuntimeError) as want:
        jinfer.make_pointmap_fn("")
    with pytest.raises(RuntimeError) as got:
        mast3r_infer.make_pointmap_fn("", device="cpu")
    assert str(got.value) == str(want.value)


def test_cli_runs_on_cpu_and_needs_a_card_by_default(tmp_path, monkeypatch):
    files = write_oracle_scene(tmp_path / "scene")
    assert len(files) == N_IMAGES
    argv = ["-s", str(tmp_path / "scene"), "-m", str(tmp_path / "out"),
            "--n_views", "3", "--ckpt_path", "random:0", "--image_size",
            "64", "--niter", "5", "--focal_avg", "--co_vis_dsp",
            "--conf_aware_ranking"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            init_cli.main(argv)
    # more cards than exist: refused before any rank starts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards; 1 visible"):
        init_cli.main(argv + ["--n_devices", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="every local CUDA card"):
        init_cli.main(argv + ["--n_devices", "-1", "--device", "cpu"])
    built = []
    build = mast3r.build_model

    def tiny(ckpt_path, cfg, **kw):  # the full ViT-L is for the card
        model = build(ckpt_path, TINY, **kw)
        built.append((ckpt_path, cfg, model.dtype))
        return model

    monkeypatch.setattr(mast3r, "build_model", tiny)
    al = init_cli.main(argv + ["--device", "cpu"])
    assert built == [("random:0", mast3r.MASt3RConfig(), torch.bfloat16)]
    sparse0 = tmp_path / "scene" / "sparse_3" / "0"
    for f in ("images.txt", "images.bin", "cameras.txt", "points3D.ply",
              "confidence_dsp.npy", "non_scaled_focals.npy"):
        assert (sparse0 / f).is_file(), f
    assert (tmp_path / "scene" / "sparse_3" / "1" / "images.txt").is_file()
    assert np.isfinite(al.get_im_poses()).all()
    assert np.isfinite(np.load(sparse0 / "points3D_all.npy")).all()
