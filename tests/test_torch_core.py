"""Core maths and data I/O of the PyTorch port against the JAX package, on
the same seeded numpy inputs (atol 1e-6 / rtol 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.ops import knn as jknn
from instantsplat_tpu.utils import schedules as jsched
from instantsplat_tpu.utils import sh as jsh
from instantsplat_tpu.utils import transforms as jT
from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.data import colmap, png, ply
from instantsplat_tpu_torch.data import images as image_io
from instantsplat_tpu_torch.models.gaussians import (
    PARAM_FIELDS,
    GaussianModel,
)
from instantsplat_tpu_torch.ops.knn import mean_knn_dist2
from instantsplat_tpu_torch.utils import schedules, sh
from instantsplat_tpu_torch.utils import transforms as T

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def test_quat_normalize_and_rotmat():
    q = _quats(np.random.default_rng(0), 64)
    np.testing.assert_allclose(T.quat_normalize(torch.tensor(q)).numpy(),
                               np.asarray(jT.quat_normalize(jnp.asarray(q))),
                               **TOL)
    np.testing.assert_allclose(T.quat_to_rotmat(torch.tensor(q)).numpy(),
                               np.asarray(jT.quat_to_rotmat(jnp.asarray(q))),
                               **TOL)


def test_pose_to_matrix_torch_and_numpy():
    rng = np.random.default_rng(1)
    pose = np.concatenate([_quats(rng, 5), rng.normal(size=(5, 3))],
                          1).astype(np.float32)
    want = np.asarray(jT.pose_to_matrix(jnp.asarray(pose)))
    np.testing.assert_allclose(T.pose_to_matrix(torch.tensor(pose)).numpy(),
                               want, **TOL)
    np.testing.assert_allclose(T.pose_to_matrix_np(pose),
                               jT.pose_to_matrix_np(pose), **TOL)
    np.testing.assert_allclose(T.matrix_to_pose_np(want),
                               jT.matrix_to_pose_np(want), **TOL)


def test_sh_constants_and_rgb_to_sh():
    for name in ("C0", "C1", "C2", "C3", "C4"):
        assert getattr(sh, name) == getattr(jsh, name)
    assert [sh.num_sh_coeffs(d) for d in range(5)] == [
        jsh.num_sh_coeffs(d) for d in range(5)]
    rgb = np.random.default_rng(2).uniform(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.rgb_to_sh(torch.tensor(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))),
                               **TOL)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
         max_steps=30_000),
    dict(lr_init=1e-4, lr_final=1e-6, lr_delay_steps=500, lr_delay_mult=0.01,
         max_steps=1000),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr(kw):
    steps = [-1, 0, 1, 7, 250, 999, 1000, 30_000, 40_000]
    ours, ref = schedules.expon_lr(**kw), jsched.expon_lr(**kw)
    for s in steps:
        np.testing.assert_allclose(float(ours(s)), float(ref(s)), **TOL)


@pytest.mark.parametrize("n,chunk", [(700, 1024), (1500, 256)])
def test_mean_knn_dist2(n, chunk):
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(n, 3)) * 0.5 + [1.0, -2.0, 3.0]).astype(
        np.float32)
    got = mean_knn_dist2(torch.tensor(pts), k=3, chunk=chunk).numpy()
    want = np.asarray(jknn.mean_knn_dist2(jnp.asarray(pts), k=3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    cols = rng.uniform(size=(400, 3)).astype(np.float32)
    poses = np.concatenate([_quats(rng, 2), rng.normal(size=(2, 3))],
                           1).astype(np.float32)
    ours = GaussianModel.create_from_pcd(pts, cols, cam_poses=poses,
                                         max_sh_degree=2, device="cpu")
    ref = JGaussians.create_from_pcd(pts, cols, cam_poses=poses,
                                     max_sh_degree=2)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)
    w2c = T.pose_to_matrix_np(poses)
    np.testing.assert_allclose(
        GaussianModel.init_cam_poses_from_w2c(w2c),
        np.asarray(JGaussians.init_cam_poses_from_w2c(w2c)), **TOL)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# ---- data I/O ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_png_reader_matches_pillow(tmp_path, mode):
    rng = np.random.default_rng(4)
    # smooth content + noise, so Pillow's adaptive row filters vary
    y, x = np.mgrid[0:37, 0:53]
    base = (x * 3 + y * 5)[..., None] + rng.integers(0, 40, (37, 53, 4))
    arr = (base % 256).astype(np.uint8)
    img = Image.fromarray(arr, "RGBA").convert(mode)
    path = tmp_path / f"im_{mode}.png"
    img.save(path)
    got = png.read_png(path)
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(
        image_io.load_image(path),
        np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_read_by_pillow(tmp_path, channels):
    arr = np.random.default_rng(5).integers(
        0, 256, (21, 34, channels)).astype(np.uint8)
    png.write_png(tmp_path / "w.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")),
                                  arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / "w.png"), arr)


def test_colmap_text_and_binary_round_trip(tmp_path):
    from instantsplat_tpu.data import colmap as jcolmap

    rng = np.random.default_rng(6)
    cams = {i: colmap.ColmapCamera(i, "PINHOLE", 64, 48,
                                   rng.uniform(30, 60, 4)) for i in (1, 2)}
    ims = {i: colmap.ColmapImage(i, colmap.rotmat_to_qvec(
        T.quat_to_rotmat(torch.tensor(_quats(rng, 1)[0])).numpy()),
        rng.normal(size=3), i, f"{i:03d}.png") for i in (1, 2)}
    colmap.write_cameras_text(cams, tmp_path / "cameras.txt")
    colmap.write_images_text(ims, tmp_path / "images.txt")
    colmap.write_cameras_binary(cams, tmp_path / "cameras.bin")
    colmap.write_images_binary(ims, tmp_path / "images.bin")
    for reader in (jcolmap.read_images_text, colmap.read_images_text):
        got = reader(tmp_path / "images.txt")
        for i in ims:
            np.testing.assert_allclose(got[i].w2c, ims[i].w2c, atol=1e-12)
    for reader in (jcolmap.read_images_binary, colmap.read_images_binary):
        got = reader(tmp_path / "images.bin")
        assert [got[i].name for i in (1, 2)] == ["001.png", "002.png"]
    for reader in (colmap.read_cameras_binary, jcolmap.read_cameras_binary,
                   jcolmap.read_cameras_text):
        suffix = "txt" if reader is jcolmap.read_cameras_text else "bin"
        got = reader(tmp_path / f"cameras.{suffix}")
        np.testing.assert_allclose(got[2].params, cams[2].params)


def test_point_cloud_ply_cross_package(tmp_path):
    from instantsplat_tpu.data import ply as jply

    rng = np.random.default_rng(7)
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (100, 3))
    ply.store_point_cloud(tmp_path / "a.ply", xyz, rgb)
    jply.store_point_cloud(tmp_path / "b.ply", xyz, rgb)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    got = ply.fetch_point_cloud(tmp_path / "b.ply")
    np.testing.assert_array_equal(got[0], xyz)
    np.testing.assert_allclose(got[1], rgb / 255.0, rtol=1e-6)


def test_gaussian_ply_byte_identical(tmp_path):
    from instantsplat_tpu.data import ply as jply

    rng = np.random.default_rng(8)
    arrays = {f: rng.normal(size=s).astype(np.float32) for f, s in [
        ("xyz", (30, 3)), ("features_dc", (30, 1, 3)),
        ("features_rest", (30, 8, 3)), ("scaling", (30, 3)),
        ("rotation", (30, 4)), ("opacity", (30, 1)), ("cam_poses", (2, 7))]}
    ours = GaussianModel(**{k: torch.tensor(v) for k, v in arrays.items()},
                         max_sh_degree=2)
    ref = JGaussians(**{k: jnp.asarray(v) for k, v in arrays.items()},
                     max_sh_degree=2)
    ply.save_gaussian_ply(tmp_path / "a.ply", ours)
    jply.save_gaussian_ply(tmp_path / "b.ply", ref)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    back = ply.load_gaussian_ply(tmp_path / "b.ply", max_sh_degree=2,
                                 device="cpu")
    for f in PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(back, f).numpy(), arrays[f])


def test_jax_backend_is_cpu():
    assert jax.default_backend() == "cpu"
