"""The port's scene and model I/O against the JAX package's, on the CPU:

- `export_matches_to_colmap_db`: every table's rows equal to those of
  JAX's database for the same inputs;
- EXR: files written by each package byte-equal; each package reads the
  other's; the port's C++ codec (built here with g++) equal to its Python
  decoder for NONE/ZIPS/ZIP, float and half; a corrupt block raises;
- `read_nerf_synthetic`: cameras, images, poses and the stored cloud
  equal to JAX's on tests/test_paths_readers.py's Blender scene (RGBA
  PNGs, written here with the port's codec and read by JAX with Pillow).
"""

import json
import sqlite3
import struct

import numpy as np
import pytest
import torch

from instantsplat_tpu.data import colmap_db as jdb
from instantsplat_tpu.data import exr as jexr
from instantsplat_tpu.data import images as jimages
from instantsplat_tpu.data import scene as jscene
from instantsplat_tpu_torch.data import colmap_db, exr, images, png, scene

torch.set_num_threads(2)


def _tables(path):
    con = sqlite3.connect(path)
    out = {t: con.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
           for t in ("cameras", "images", "keypoints", "descriptors",
                     "matches", "two_view_geometries")}
    con.close()
    return out


@pytest.mark.parametrize("priors", [False, True])
def test_colmap_db_matches_jax(tmp_path, priors):
    rng = np.random.default_rng(0)
    edges = [(0, 1), (1, 0), (1, 2), (2, 0)]
    matches = [(rng.integers(0, 64, (n, 2)), rng.integers(0, 48, (n, 2)))
               for n in (12, 9, 0, 5)]
    w2c = None
    if priors:
        w2c = np.tile(np.eye(4), (3, 1, 1))
        for k in range(3):
            a = 0.1 * (k + 1)
            w2c[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]]
            w2c[k, :3, 3] = rng.standard_normal(3)
    args = (["a.png", "b.png", "c.png"], (48, 64), [100.0, 110.0, 120.0],
            matches, edges)
    ids = colmap_db.export_matches_to_colmap_db(tmp_path / "port.db", *args,
                                                w2c_priors=w2c)
    jids = jdb.export_matches_to_colmap_db(tmp_path / "jax.db", *args,
                                           w2c_priors=w2c)
    assert ids == jids
    got, ref = _tables(tmp_path / "port.db"), _tables(tmp_path / "jax.db")
    assert got == ref
    assert len(got["images"]) == 3 and len(got["matches"]) == 2
    assert colmap_db.pair_id_from_images(5, 2) == jdb.pair_id_from_images(
        5, 2)


def _exr_cases():
    rng = np.random.default_rng(42)
    # odd sizes and more than 16 rows: ZIP gets full and partial blocks
    return {"depth": (rng.random((37, 53)) * 100 - 50).astype(np.float32),
            "rgb": rng.standard_normal((45, 31, 3)).astype(np.float32) * 1e8}


@pytest.mark.parametrize("comp", ["none", "zips", "zip"])
@pytest.mark.parametrize("half", [False, True])
def test_exr_across_packages_and_decoders(tmp_path, comp, half):
    for name, img in _exr_cases().items():
        if half and name == "rgb":
            img = img * 1e-8  # inside half's range
        p, q = tmp_path / f"port_{name}.exr", tmp_path / f"jax_{name}.exr"
        exr.write_exr(p, img, half=half, compression=comp)
        jexr.write_exr(q, img, half=half, compression=comp)
        assert p.read_bytes() == q.read_bytes()
        native = exr.read_exr(q)
        plain = exr.read_exr(q, native=False)
        assert native.dtype == plain.dtype and native.shape == plain.shape
        assert np.array_equal(native, plain)
        assert np.array_equal(native, jexr.read_exr(p))
        if not half:
            assert np.array_equal(native, img[..., ::-1] if img.ndim == 3
                                  else img)  # channels alphabetical: B G R


def test_exr_codec_builds_into_build_dir():
    path = exr.build_native()
    assert path.is_file()
    assert path.parent.parent.name == "instantsplat_tpu_torch"
    assert path.parent.parent.parent.name == "build"


def _clobber(tmp_path, how):
    img = np.ones((20, 20), np.float32)
    p = tmp_path / f"c_{how}.exr"
    exr.write_exr(p, img, compression="zip")
    buf = bytearray(p.read_bytes())
    if how == "payload":
        buf[-30:] = b"\x00" * 30
    else:  # the first block's y below the data window
        off = 8
        while True:
            name, off = exr._read_cstr(buf, off)
            if not name:
                break
            _, off = exr._read_cstr(buf, off)
            (size,) = struct.unpack_from("<i", bytes(buf), off)
            off += 4 + size
        off += 8 * 2
        struct.pack_into("<i", buf, off, -16)
    p.write_bytes(bytes(buf))
    return p


@pytest.mark.parametrize("how", ["payload", "window"])
def test_exr_corrupt_block_raises(tmp_path, how):
    p = _clobber(tmp_path, how)
    with pytest.raises((RuntimeError, ValueError)):
        exr.read_exr(p)
    if how == "window":
        with pytest.raises((RuntimeError, ValueError)):
            exr.read_exr(p, native=False)


def test_exr_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(exr, "_SRC", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("#include <no_such_header.h>\n")
    monkeypatch.setattr(exr, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="zlib.h"):
        exr.build_native()


def _blender_scene(root, n=3, with_test=False):
    """tests/test_paths_readers.py's scene: three RGBA frames on a circle,
    written with the port's PNG codec."""
    rng = np.random.default_rng(0)
    for split, count in (("train", n), ("test", 2 if with_test else 0)):
        if not count:
            continue
        (root / split).mkdir()
        frames = []
        for i in range(count):
            a = 0.3 * i + (0.1 if split == "test" else 0.0)
            c2w = np.eye(4)
            c2w[:3, 3] = [np.sin(a), 0, np.cos(a)]
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
            png.write_png(root / f"{split}/r_{i}.png",
                          (rng.random((32, 40, 4)) * 255).astype(np.uint8))
        json.dump({"camera_angle_x": 0.7, "frames": frames},
                  open(root / f"transforms_{split}.json", "w"))


@pytest.mark.parametrize("white,with_test,eval_split", [
    (False, False, True), (True, True, True), (True, True, False)])
def test_read_nerf_synthetic_matches_jax(tmp_path, white, with_test,
                                         eval_split):
    a, b = tmp_path / "port", tmp_path / "jax"
    for root in (a, b):
        root.mkdir()
        _blender_scene(root, with_test=with_test)
    info, tcams, tposes = scene.read_nerf_synthetic(
        a, white_background=white, eval_split=eval_split,
        num_random_pts=500, device="cpu")
    jinfo, jtcams, jtposes = jscene.read_nerf_synthetic(
        b, white_background=white, eval_split=eval_split,
        num_random_pts=500)
    assert ((a / "points3d.ply").read_bytes()
            == (b / "points3d.ply").read_bytes())
    np.testing.assert_array_equal(info.points, jinfo.points)
    np.testing.assert_array_equal(info.colors, jinfo.colors)
    np.testing.assert_array_equal(info.poses_w2c, jinfo.poses_w2c)
    np.testing.assert_array_equal(tposes, jtposes)
    assert info.image_names == jinfo.image_names
    assert info.nerf_radius == jinfo.nerf_radius
    assert len(tcams) == len(jtcams)
    for c, jc in zip(info.cameras + tcams, jinfo.cameras + jtcams):
        np.testing.assert_array_equal(c.image.numpy(), np.asarray(jc.image))
        np.testing.assert_array_equal(c.pose.numpy(), np.asarray(jc.pose))
        for k in ("fx", "fy", "cx", "cy"):
            assert float(getattr(c, k)) == float(getattr(jc, k)), k
        assert (c.height, c.width, c.uid) == (jc.height, jc.width, jc.uid)
    np.testing.assert_allclose(info.poses_w2c[0][:3, :3],
                               np.diag([1.0, -1.0, -1.0]), atol=1e-12)
    # the cloud is drawn once: a second read loads the stored one
    again, _, _ = scene.read_nerf_synthetic(a, num_random_pts=7,
                                            device="cpu")
    np.testing.assert_array_equal(again.points, info.points)


def test_load_images_from_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for k in (10, 2, 1):
        images.save_image(tmp_path / f"f{k}.png",
                          rng.random((48, 64, 3)).astype(np.float32))
    got = images.load_images_from_dir(tmp_path, size=64)
    ref = jimages.load_images_from_dir(tmp_path, size=64)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert tuple(got[1]) == tuple(ref[1]) and got[2:] == ref[2:]
