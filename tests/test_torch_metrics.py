"""Stage 5 of the port against the JAX package, on the CPU.

- image metrics: SSIM and PSNR within 1e-6 (PSNR relative); LPIPS with the JAX
  LpipsVGG.random(0) weights carried over by convert.lpips_from_numpy
  (HWIO -> OIHW) within rtol 1e-4 on 32x32 pairs; the port's own
  random(0) draws the same weights; without weights both raise;
- save_image / load_image across the packages: a PNG written by one reads
  pixel-equal in the other, NaN and +-inf included;
- pose metrics (Procrustes, Umeyama sim3, ATE, RPE): the same float64
  numbers to 1e-10;
- the metrics stage and its CLI with --device cpu on a written render
  tree: results.json, per_view.json, metrics.txt and pose_eval.txt as the
  JAX stage writes them; without a card the CLI raises.
"""

import json
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.data import images as jimages
from instantsplat_tpu.eval import image_metrics as jim
from instantsplat_tpu.eval import pose_metrics as jpm
from instantsplat_tpu.pipelines import metrics_pipeline as jmetrics
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.cli import metrics as metrics_cli
from instantsplat_tpu_torch.data import colmap, images
from instantsplat_tpu_torch.eval import image_metrics as im
from instantsplat_tpu_torch.eval import pose_metrics as pm
from instantsplat_tpu_torch.pipelines import metrics_pipeline
from instantsplat_tpu_torch.utils import transforms as T

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape) * 0.15, 0, 1).astype(np.float32)
    return a, b


# ---- image metrics ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64, 3), (37, 29, 3)])
def test_ssim_psnr_match_jax(shape):
    """SSIM (in [0, 1]) within 1e-6, PSNR (~20 dB) within 1e-6 of
    itself: float32 sums in another order."""
    a, b = _pair(0, shape)
    for name, rtol, atol in (("ssim", 0, 1e-6), ("psnr", 1e-6, 0)):
        got = float(getattr(im, name)(torch.tensor(a), torch.tensor(b)))
        want = float(getattr(jim, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def lpips_nets():
    jnet = jim.LpipsVGG.random(0)
    net = convert.lpips_from_numpy(
        [np.asarray(w) for w in jnet.conv_w],
        [np.asarray(b) for b in jnet.conv_b],
        [np.asarray(w) for w in jnet.lin_w], device="cpu")
    return jnet, net


@pytest.mark.parametrize("seed", [1, 2])
def test_lpips_matches_jax(lpips_nets, seed):
    jnet, net = lpips_nets
    a, b = _pair(seed, (32, 32, 3))
    got = float(im.lpips(torch.tensor(a), torch.tensor(b), net))
    want = float(jim.lpips(jnp.asarray(a), jnp.asarray(b), jnet))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert float(im.lpips(torch.tensor(a), torch.tensor(a), net)) == 0.0


def test_lpips_random_weights_equal_jax(lpips_nets):
    _, net = lpips_nets
    own = im.LpipsVGG.random(0, device="cpu")
    for name, t in net.state_dict().items():
        torch.testing.assert_close(own.state_dict()[name], t, rtol=0,
                                   atol=0, msg=name)


def test_lpips_from_torch_files(lpips_nets, tmp_path):
    """torchvision / richzhang state-dict keys load as they are (OIHW)."""
    _, net = lpips_nets
    convs = [c for c in net.convs]
    feats = {}
    for li, conv in zip(im._TORCHVISION_CONVS, convs):
        feats[f"features.{li}.weight"] = conv.weight.clone()
        feats[f"features.{li}.bias"] = conv.bias.clone()
    torch.save(feats, tmp_path / "vgg.pth")
    torch.save({f"lin{i}.model.1.weight": lin.weight.clone()
                for i, lin in enumerate(net.lins)}, tmp_path / "lin.pth")
    loaded = im.LpipsVGG.from_torch_files(tmp_path / "vgg.pth",
                                          tmp_path / "lin.pth", device="cpu")
    for name, t in net.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[name], t, rtol=0,
                                   atol=0, msg=name)


def test_lpips_without_weights_raises():
    x = np.zeros((8, 8, 3), np.float32)
    assert im.default_lpips() is None and jim._DEFAULT is None
    with pytest.raises(RuntimeError, match="LPIPS weights unavailable"):
        im.lpips(torch.tensor(x), torch.tensor(x))
    with pytest.raises(RuntimeError, match="LPIPS weights unavailable"):
        jim.lpips(jnp.asarray(x), jnp.asarray(x))


# ---- images across the packages -------------------------------------------


def _special_image():
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (9, 11, 3)).astype(np.float32)
    img[0, 0] = [np.nan, np.inf, -np.inf]
    img[1, 1] = [0.5 / 255, 1.5 / 255, 254.5 / 255]
    return img


def test_save_image_cross_package(tmp_path):
    img = _special_image()
    images.save_image(tmp_path / "port.png", img)
    jimages.save_image(tmp_path / "jax.png", img)
    for name in ("port.png", "jax.png"):
        a = images.load_image(tmp_path / name)
        b = jimages.load_image(tmp_path / name)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(images.load_image(tmp_path / "port.png"),
                                  images.load_image(tmp_path / "jax.png"))
    px = np.round(images.load_image(tmp_path / "port.png") * 255)
    np.testing.assert_array_equal(px[0, 0], [0, 255, 0])


# ---- pose metrics ----------------------------------------------------------


def _trajectories(seed, n=6):
    """Ground-truth c2w on an arc, and an estimate that is a scaled,
    rotated, shifted and noisy copy of it."""
    rng = np.random.default_rng(seed)
    gt = []
    for ang in np.linspace(-0.5, 0.5, n):
        c2w = np.eye(4)
        c, s = np.cos(ang), np.sin(ang)
        c2w[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        c2w[:3, 3] = [4 * s, 0.2 * ang, -4 * c]
        gt.append(c2w)
    gt = np.stack(gt)
    q = rng.normal(size=4)
    R = T.qvec_to_rotmat(q / np.linalg.norm(q))
    est = gt.copy()
    est[:, :3, :3] = R @ gt[:, :3, :3]
    est[:, :3, 3] = 0.7 * gt[:, :3, 3] @ R.T + rng.normal(size=3)
    est[:, :3, 3] += rng.normal(size=(n, 3)) * 0.05
    return est, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_metrics_match_jax(seed):
    est, gt = _trajectories(seed)
    got, want = pm.evaluate_pose(est, gt), jpm.evaluate_pose(est, gt)
    assert got.keys() == want.keys() == {"RPE_t", "RPE_r", "ATE"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10)
    for a, b in zip(pm.umeyama(gt[:, :3, 3], est[:, :3, 3]),
                    jpm.umeyama(gt[:, :3, 3], est[:, :3, 3])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    for a, b in zip(pm.align_pose(gt[:, :3, 3], est[:, :3, 3]),
                    jpm.align_pose(gt[:, :3, 3], est[:, :3, 3])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    aligned = pm.align_ate_c2b_use_a2b(est, gt)
    np.testing.assert_allclose(aligned, jpm.align_ate_c2b_use_a2b(est, gt),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(pm.compute_ate(gt, aligned),
                               jpm.compute_ate(gt, aligned), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(pm.compute_rpe(gt, aligned),
                               jpm.compute_rpe(gt, aligned), rtol=0,
                               atol=1e-10)


def test_pose_metrics_of_an_exact_copy_are_zero():
    est, gt = _trajectories(2)
    est = gt.copy()
    est[:, :3, 3] *= 3.0  # a scaled copy aligns exactly
    res = pm.evaluate_pose(est, gt)
    for k in res:
        assert abs(res[k]) < 1e-6, (k, res[k])


# ---- the metrics stage -----------------------------------------------------


def write_eval_tree(root: Path, n_test=3, seed=4):
    """<root>/model/test/ours_7/{renders,gt}/*.png, the optimised train
    poses and <root>/src/sparse/0/images.txt (15 views; the train subset
    of split_train_test(., 3) is indices 0, 12, 14)."""
    rng = np.random.default_rng(seed)
    mdir = root / "model" / "test" / "ours_7"
    for i in range(n_test):
        gt = rng.uniform(size=(24, 32, 3))
        images.save_image(mdir / "gt" / f"{i:05d}.png", gt)
        images.save_image(mdir / "renders" / f"{i:05d}.png",
                          np.clip(gt + rng.normal(size=gt.shape) * 0.1, 0, 1))
    est, gt_c2w = _trajectories(seed, 15)
    pdir = root / "model" / "pose" / "ours_7"
    pdir.mkdir(parents=True)
    np.save(pdir / "pose_optimized.npy", np.linalg.inv(est[[0, 12, 14]]))
    ims = {}
    for k, c2w in enumerate(gt_c2w):
        w2c = np.linalg.inv(c2w)
        ims[k + 1] = colmap.ColmapImage(k + 1, T.rotmat_to_qvec(w2c[:3, :3]),
                                        w2c[:3, 3], 1, f"{k:03d}.png")
    (root / "src" / "sparse" / "0").mkdir(parents=True)
    colmap.write_images_text(ims, root / "src" / "sparse" / "0"
                             / "images.txt")


def test_metrics_cli_matches_jax(tmp_path, capsys):
    write_eval_tree(tmp_path)
    shutil.copytree(tmp_path / "model", tmp_path / "jmodel")
    metrics_cli.main(["-m", str(tmp_path / "model"), "-s",
                      str(tmp_path / "src"), "--n_views", "3", "--device",
                      "cpu"])
    assert "[metrics]" in capsys.readouterr().out
    jmetrics.run_metrics([tmp_path / "jmodel"], str(tmp_path / "src"), 3)
    a = json.loads((tmp_path / "model" / "results.json").read_text())
    b = json.loads((tmp_path / "jmodel" / "results.json").read_text())
    assert a.keys() == b.keys() == {"ours_7"}
    assert a["ours_7"].keys() == b["ours_7"].keys()
    assert a["ours_7"]["LPIPS"] is None and b["ours_7"]["LPIPS"] is None
    for k, v in a["ours_7"].items():
        if v is not None:
            np.testing.assert_allclose(v, b["ours_7"][k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    pa = json.loads((tmp_path / "model" / "per_view.json").read_text())
    pb = json.loads((tmp_path / "jmodel" / "per_view.json").read_text())
    assert pa["ours_7"]["LPIPS"] == pb["ours_7"]["LPIPS"]
    assert pa["ours_7"]["PSNR"].keys() == pb["ours_7"]["PSNR"].keys()
    rel = "pose/ours_7/pose_eval.txt"
    assert (tmp_path / "model" / rel).read_text() == \
        (tmp_path / "jmodel" / rel).read_text()
    # the same lines; a value within 1e-6 may round the other way
    a, b = ((tmp_path / m / "test/ours_7/metrics.txt").read_text()
            for m in ("model", "jmodel"))
    assert re.sub(r"\d", "#", a) == re.sub(r"\d", "#", b)
    np.testing.assert_allclose(
        [float(x) for x in re.findall(r"\d+\.\d+", a)],
        [float(x) for x in re.findall(r"\d+\.\d+", b)], rtol=0,
        atol=0.01 + 1e-9)


def test_evaluate_images_with_lpips_matches_jax(lpips_nets, tmp_path):
    jnet, net = lpips_nets
    write_eval_tree(tmp_path, n_test=2)
    mdir = tmp_path / "model" / "test" / "ours_7"
    summary, per_view = metrics_pipeline.evaluate_images(mdir, net,
                                                         device="cpu")
    jsummary, jper_view = jmetrics.evaluate_images(mdir, jnet)
    np.testing.assert_allclose(summary["LPIPS"], jsummary["LPIPS"],
                               rtol=1e-4)
    for name, v in per_view["LPIPS"].items():
        np.testing.assert_allclose(v, jper_view["LPIPS"][name], rtol=1e-4)


def test_metrics_without_card_raises(tmp_path, monkeypatch):
    write_eval_tree(tmp_path, n_test=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        metrics_cli.main(["-m", str(tmp_path / "model")])
