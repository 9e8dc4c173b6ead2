"""Stages 3 and 5 of the port against the JAX package, on the CPU.

- camera paths, the step-function sampler, the train/test split and the
  GT pose reader: the same numpy (float64) results to 1e-10;
- the masked L1 and the test-time pose refiner (10 Adam steps on one
  perturbed view; JAX with backend "oracle", the port on the CPU): best
  pose within atol 1e-5, best loss within rtol 1e-5;
- cfg_args written by either package merged by the other's
  get_combined_args;
- the slice on a tiny scene: port training, then the port's run_render
  (5 refinement steps) and run_metrics, against JAX's run_render and
  run_metrics on a copy of the same trained model: results.json within
  rtol 1e-5 per field; JAX's run_metrics over the port's renders gives
  the port's results.json within 1e-6; the interpolated path and its
  frames;
- the render CLI with --device cpu, and without a card.
"""

import json
import shutil
from argparse import Namespace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.data import scene as jscene
from instantsplat_tpu.models.camera import Camera as JCam
from instantsplat_tpu.models.gaussians import GaussianModel as JG
from instantsplat_tpu.ops import losses as jlosses
from instantsplat_tpu.pipelines import config as jconfig
from instantsplat_tpu.pipelines import metrics_pipeline as jmetrics
from instantsplat_tpu.pipelines import render_pipeline as jrender
from instantsplat_tpu.utils import camera_paths as jpaths
from instantsplat_tpu.utils import stepfun as jstepfun
from instantsplat_tpu_torch.cli import render as render_cli
from instantsplat_tpu_torch.data import png
from instantsplat_tpu_torch.data import scene
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.ops import losses
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines import config
from instantsplat_tpu_torch.pipelines import metrics_pipeline
from instantsplat_tpu_torch.pipelines import render_pipeline
from instantsplat_tpu_torch.pipelines import train_pipeline
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig
from instantsplat_tpu_torch.utils import camera_paths, stepfun
from instantsplat_tpu_torch.utils import transforms as T
from torch_scenes import (H, TEST_ANGLES, W, look_at, refine_case,
                          write_eval_scene)

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)


def _rng_poses(seed, n):
    """[n, 4, 4] c2w poses on a noisy arc, float64."""
    rng = np.random.default_rng(seed)
    out = []
    for ang in np.linspace(-0.6, 0.6, n):
        eye = np.array([4 * np.sin(ang), 0.2, -4 * np.cos(ang)])
        out.append(np.linalg.inv(look_at(eye + rng.normal(size=3) * 0.1)))
    return np.stack(out)


# ---- numpy modules: the same numbers --------------------------------------


@pytest.mark.parametrize("n_views", [2, 3, 5])
def test_video_path_matches_jax(n_views):
    w2c = np.linalg.inv(_rng_poses(n_views, n_views))
    np.testing.assert_allclose(
        camera_paths.video_path_from_train_poses(w2c, n_views, seconds=2),
        jpaths.video_path_from_train_poses(w2c, n_views, seconds=2),
        rtol=0, atol=1e-10)


def test_interpolated_path_matches_jax():
    poses = _rng_poses(1, 6)
    np.testing.assert_allclose(
        camera_paths.generate_interpolated_path(poses, 7),
        jpaths.generate_interpolated_path(poses, 7), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n_test", [2, 12])
def test_test_pose_init_matches_jax(n_test):
    w2c = np.linalg.inv(_rng_poses(2, 3))
    np.testing.assert_allclose(
        camera_paths.test_pose_init_from_train(w2c, n_test),
        jpaths.test_pose_init_from_train(w2c, n_test), rtol=0, atol=1e-10)


@pytest.mark.parametrize("const_speed", [True, False])
def test_ellipse_path_matches_jax(const_speed):
    poses = _rng_poses(3, 8)
    np.testing.assert_allclose(
        camera_paths.generate_ellipse_path(poses, 30, const_speed,
                                           z_variation=0.3),
        jpaths.generate_ellipse_path(poses, 30, const_speed,
                                     z_variation=0.3),
        rtol=0, atol=1e-10)


def test_spiral_path_matches_jax():
    poses = _rng_poses(4, 6)
    bounds = np.random.default_rng(4).uniform(1, 5, (6, 2))
    np.testing.assert_allclose(
        camera_paths.generate_spiral_path(poses, bounds, 20),
        jpaths.generate_spiral_path(poses, bounds, 20), rtol=0, atol=1e-10)


def test_stepfun_sample_matches_jax():
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 3, 17))
    w = rng.normal(size=16)
    for rand in (None, np.random.default_rng(6)):
        got = stepfun.sample_np(rand, t, w, 40)
        rand2 = None if rand is None else np.random.default_rng(6)
        np.testing.assert_allclose(got, jstepfun.sample_np(rand2, t, w, 40),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,n_views", [(15, 3), (24, 3), (30, 9)])
def test_split_train_test_matches_jax(n, n_views):
    items = [f"{i:03d}.png" for i in range(n)]
    assert scene.split_train_test(items, n_views) == \
        jscene.split_train_test(items, n_views)


# ---- losses and the refiner ------------------------------------------------


def test_masked_losses_match_jax():
    rng = np.random.default_rng(7)
    a, b = (rng.uniform(size=(12, 10, 3)).astype(np.float32)
            for _ in range(2))
    for mask in (a[..., 0] > 0.5, np.zeros((12, 10), bool), a > 0.3):
        np.testing.assert_allclose(
            float(losses.masked_l1_loss(torch.tensor(a), torch.tensor(b),
                                        torch.tensor(mask))),
            float(jlosses.masked_l1_loss(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(mask))), rtol=1e-6)
    for name in ("l1_loss", "l2_loss"):
        np.testing.assert_allclose(
            float(getattr(losses, name)(torch.tensor(a), torch.tensor(b))),
            float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6)


@pytest.fixture(scope="module")
def refined():
    arrays, M, gt, pose0 = refine_case()
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                        width=W, image=gt, device="cpu")
    tensors_before = [t.clone() for t in g.tensors()]
    pose, loss = render_pipeline.make_pose_refiner(
        g, cam, backend="pallas", num_iter=10)(pose0, cam.image)
    jg = JG(**{f: jnp.asarray(v) for f, v in arrays.items()},
            max_sh_degree=1)
    jcam = JCam.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                       width=W, image=gt)
    jpose, jloss = jrender.make_pose_refiner(
        jg, jcam, backend="oracle", num_iter=10)(jnp.asarray(pose0),
                                                 jcam.image)
    return dict(pose=pose, loss=loss, jpose=np.asarray(jpose),
                jloss=float(jloss), g=g, before=tensors_before,
                pose0=pose0, gt_pose=T.matrix_to_pose_np(M))


def test_refiner_matches_jax(refined):
    np.testing.assert_allclose(refined["pose"].numpy(), refined["jpose"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(refined["loss"]), refined["jloss"],
                               rtol=1e-5)


def test_refiner_freezes_gaussians_and_moves_the_pose(refined):
    for t, before in zip(refined["g"].tensors(), refined["before"]):
        assert t.grad is None and not t.requires_grad
        torch.testing.assert_close(t, before, rtol=0, atol=0)
    d0 = np.abs(refined["pose0"] - refined["gt_pose"]).max()
    d1 = np.abs(refined["pose"].numpy() - refined["gt_pose"]).max()
    assert d1 < d0


def test_refiner_latches_the_pose_of_the_best_loss(monkeypatch):
    """The latch keeps the pose at which the lowest loss was taken: with a
    loss that only rises, the start pose is returned, not the one its
    step moved to."""
    arrays, M, gt, pose0 = refine_case()
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                        width=W, image=gt, device="cpu")
    calls = []

    def rising(pred, target, mask):
        calls.append(1)
        return (pred - target).abs().mean() * 0 + len(calls) + \
            pred.sum() * 1e-3

    monkeypatch.setattr(render_pipeline, "masked_l1_loss", rising)
    pose, loss = render_pipeline.make_pose_refiner(
        g, cam, backend="pallas", num_iter=3)(pose0, cam.image)
    np.testing.assert_array_equal(pose.numpy(), pose0)
    assert len(calls) == 3


# ---- cfg_args across the packages -----------------------------------------


def test_cfg_args_cross_package(tmp_path):
    """A cfg_args written by either package, merged with a command line
    by the other's get_combined_args: saved values fill in, explicit ones
    win."""
    saved = Namespace(sh_degree=2, source_path="/data/scene",
                      model_path=str(tmp_path), images="images",
                      resolution=-1, white_background=True, eval=False,
                      n_views=3, init_scale_from_view_depth=False)
    for writer, reader in ((config, jconfig), (jconfig, config)):
        writer.save_cfg_args(tmp_path, saved)
        parser = render_cli.build_parser()
        args = reader.get_combined_args(
            parser, ["-m", str(tmp_path), "--n_views", "5", "--device",
                     "cpu"])
        assert args.source_path == "/data/scene"
        assert args.sh_degree == 2 and args.white_background
        assert args.n_views == 5 and args.device == "cpu"
        assert args.optim_test_pose_iter == 500


# ---- the slice: train -> render -> metrics --------------------------------


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """Port training (3 iterations), then render (5 refinement steps) and
    metrics by each package on its own copy of the trained model."""
    root = tmp_path_factory.mktemp("eval")
    src = root / "scene"
    write_eval_scene(src)
    kw = dict(sh_degree=2, source_path=str(src), n_views=3)
    train_pipeline.run_training(
        config.ModelParams(model_path=str(root / "port"), **kw),
        OptimizationConfig(pp_optimizer=True, optim_pose=True),
        TrainerConfig(iterations=3, backend="oracle"), device="cpu")
    shutil.copytree(root / "port", root / "jax")
    render_pipeline.run_render(
        config.ModelParams(model_path=str(root / "port"), **kw),
        optim_test_pose_iter=5, test_fps=False, device="cpu")
    jrender.run_render(
        jconfig.ModelParams(model_path=str(root / "jax"), **kw),
        optim_test_pose_iter=5, test_fps=False, backend="oracle")
    res = metrics_pipeline.run_metrics([root / "port"], str(src), 3,
                                       device="cpu")
    jres = jmetrics.run_metrics([root / "jax"], str(src), 3)
    shutil.copytree(root / "port", root / "port_by_jax")
    jres_port = jmetrics.run_metrics([root / "port_by_jax"], str(src), 3)
    return dict(root=root, src=src, res=res[str(root / "port")],
                jres=jres[str(root / "jax")],
                jres_port=jres_port[str(root / "port_by_jax")])


def _assert_results_close(a, b, rtol, atol=0.0):
    assert a.keys() == b.keys()
    for method in a:
        assert a[method].keys() == b[method].keys()
        for key, v in a[method].items():
            if v is None:
                assert b[method][key] is None, key
            else:
                np.testing.assert_allclose(v, b[method][key], rtol=rtol,
                                           atol=atol,
                                           err_msg=f"{method} {key}")


def test_results_json_matches_jax(slice_runs):
    root = slice_runs["root"]
    port = json.loads((root / "port" / "results.json").read_text())
    jax_ = json.loads((root / "jax" / "results.json").read_text())
    assert port == slice_runs["res"] and jax_ == slice_runs["jres"]
    assert set(port["ours_3"]) == {"SSIM", "PSNR", "LPIPS", "RPE_t",
                                   "RPE_r", "ATE"}
    assert port["ours_3"]["LPIPS"] is None
    _assert_results_close(port, jax_, rtol=1e-5)


def test_jax_metrics_over_port_renders(slice_runs):
    """ROADMAP item 11's check: the JAX metrics stage over the port's
    renders and poses gives the port's results.json: the pose metrics are
    the same numpy code; SSIM and PSNR agree within 1e-6 (float32 sums
    in another order)."""
    _assert_results_close(slice_runs["res"], slice_runs["jres_port"],
                          rtol=1e-6, atol=1e-6)
    root = slice_runs["root"]
    a = json.loads((root / "port" / "per_view.json").read_text())
    b = json.loads((root / "port_by_jax" / "per_view.json").read_text())
    assert a["ours_3"].keys() == b["ours_3"].keys()
    assert a["ours_3"]["PSNR"].keys() == b["ours_3"]["PSNR"].keys()
    assert (root / "port" / "pose" / "ours_3" / "pose_eval.txt").read_text() \
        == (root / "port_by_jax" / "pose" / "ours_3"
            / "pose_eval.txt").read_text()


def test_render_tree_matches_jax(slice_runs):
    root = slice_runs["root"]
    for tree in ("port", "jax"):
        for split, n in (("train", 3), ("test", len(TEST_ANGLES))):
            for sub in ("renders", "gt"):
                names = sorted(p.name for p in (
                    root / tree / split / "ours_3" / sub).glob("*.png"))
                assert names == [f"{i:05d}.png" for i in range(n)], \
                    (tree, split, sub)
    for split in ("train", "test"):
        for i in range(3 if split == "train" else len(TEST_ANGLES)):
            a = png.read_png(root / "port" / split / "ours_3" / "renders"
                             / f"{i:05d}.png").astype(int)
            b = png.read_png(root / "jax" / split / "ours_3" / "renders"
                             / f"{i:05d}.png").astype(int)
            assert np.abs(a - b).max() <= 1, (split, i)


def test_gt_poses_and_test_split_match_jax(slice_runs):
    src = slice_runs["src"]
    np.testing.assert_allclose(scene.read_colmap_gt_pose(src),
                               jscene.read_colmap_gt_pose(src), rtol=0,
                               atol=1e-12)
    info = scene.read_scene(src, 3, split="test", device="cpu")
    jinfo = jscene.read_scene(src, 3, split="test")
    assert info.image_names == jinfo.image_names
    np.testing.assert_array_equal(info.poses_w2c, jinfo.poses_w2c)
    assert info.ply_path == jinfo.ply_path and info.ply_path.endswith(
        str(Path("sparse_3") / "0" / "points3D.ply"))
    for c, jc in zip(info.cameras, jinfo.cameras):
        np.testing.assert_array_equal(c.image.numpy(), np.asarray(jc.image))
    bare = scene.read_scene(src, 3, split="test", load_images=False,
                            device="cpu")
    assert all(c.image is None for c in bare.cameras)


def test_interp_video_matches_jax(slice_runs, tmp_path):
    """--infer_video: the trajectory through the optimised poses and one
    frame per pose, as the JAX stage writes them."""
    root = slice_runs["root"]
    model = tmp_path / "model"
    shutil.copytree(root / "port", model)
    kw = dict(sh_degree=2, source_path=str(slice_runs["src"]), n_views=3,
              model_path=str(model))
    render_pipeline.run_render(config.ModelParams(**kw), skip_train=True,
                               infer_video=True, video_seconds=1,
                               device="cpu")
    pdir = model / "pose" / "ours_3"
    inter = np.load(pdir / "pose_interpolated.npy")
    want = jpaths.video_path_from_train_poses(
        np.load(pdir / "pose_optimized.npy"), 3, seconds=1)
    np.testing.assert_allclose(inter, want, rtol=0, atol=1e-10)
    frames = sorted((model / "interp" / "ours_3" / "renders").glob("*.png"))
    assert len(frames) == len(inter) == 2 * 10 + 1
    assert not (model / "interp" / "ours_3" / "gt").exists()


def test_render_cli_on_cpu(slice_runs, tmp_path, capsys):
    """The CLI reads the model's cfg_args (source path, SH degree, views)
    and runs on the CPU with --device cpu."""
    model = tmp_path / "model"
    shutil.copytree(slice_runs["root"] / "port", model)
    shutil.rmtree(model / "test")
    it = render_cli.main(["-m", str(model), "--device", "cpu",
                          "--optim_test_pose_iter", "2", "--skip_train"])
    assert it == 3
    assert "[render] done (iteration 3)" in capsys.readouterr().out
    assert len(list((model / "test" / "ours_3" / "renders").glob(
        "*.png"))) == len(TEST_ANGLES)


def test_render_cli_refuses_without_card_or_with_devices(slice_runs,
                                                         monkeypatch):
    model = str(slice_runs["root"] / "port")
    with pytest.raises(NotImplementedError, match="n_devices"):
        render_cli.main(["-m", model, "--device", "cpu", "--n_devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        render_cli.main(["-m", model])


def test_resolve_backend_times_dense_against_the_candidate(monkeypatch):
    """auto: one warm and one timed forward of each candidate, the faster
    kept; any other value passes through."""
    from instantsplat_tpu_torch.pipelines import trainer as tr

    arrays, M, gt, pose0 = refine_case()
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                        width=W, device="cpu")
    pose = torch.tensor(pose0)
    bg = torch.zeros(3)
    assert render_pipeline.resolve_backend(g, cam, pose, bg,
                                           "oracle") == "oracle"
    cand = tr._binned_candidate(g, cam, pose)
    assert cand is not None
    seen = []
    real = render_pipeline.render

    def slow_dense(params, camera, pose=None, bg=None, backend="oracle"):
        seen.append(backend)
        if backend == "pallas":
            clock[0] += 1.0
        return real(params, camera, pose=pose, bg=bg, backend=backend)

    clock = [0.0]
    monkeypatch.setattr(render_pipeline, "render", slow_dense)
    monkeypatch.setattr(render_pipeline, "_clock", lambda: clock[0])
    assert render_pipeline.resolve_backend(g, cam, pose, bg, "auto") == cand
    assert seen == ["pallas", "pallas", cand, cand]
