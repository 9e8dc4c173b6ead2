"""The alternative stage 3 (init_test_pose) of the port against the JAX
package's, on the CPU.

Scene: tests/test_pipeline_e2e.py's oracle scene (torch_init_cases), its
14 frames split into 3 train and 12 test views, so 15 images and 210
directed pairs through the aligner, with seeded noise of 0.01 on the
pointmaps, 30 aligner iterations. The stage-1 cloud
`sparse_3/0/points3D_all.npy` is the train views' true points, turned and
moved (torch_init_cases.write_stage1_cloud); the aligner's frame is about
half the true scale, so the registration scale s is about 2.

- both packages' `run_init_test_pose` write the same `sparse_3/1`: poses
  within atol 1e-5, intrinsics within rtol 1e-5;
- the `[R, s*T]` quirk: the port's written poses are the aligner's test
  poses under [R, s*T] of the registration it computed, translation
  scaled and rotation not, and differ from a similarity transport;
- the CLI runs on the CPU with the TINY MASt3R and, without a card,
  raises; its parser takes JAX's flags with JAX's defaults.
"""

import numpy as np
import pytest
import torch

from instantsplat_tpu.init.aligner import PairPrediction as jPairPrediction
from instantsplat_tpu.pipelines import init_test_pose_pipeline as jpipe
from instantsplat_tpu_torch.cli import init_test_pose as itp_cli
from instantsplat_tpu_torch.data import colmap
from instantsplat_tpu_torch.init import geometry as G
from instantsplat_tpu_torch.init.aligner import GlobalAligner, PairPrediction
from instantsplat_tpu_torch.models import mast3r
from instantsplat_tpu_torch.pipelines import init_test_pose_pipeline as pipe
from torch_init_cases import (SCENE_FOCAL, SCENE_H, SCENE_VIEWS, SCENE_W,
                              TINY, oracle_pointmap_fn, write_stage1_cloud)

torch.set_num_threads(2)
NITER = 30


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's run_init_test_pose on the same scene; the
    port's registration and aligner poses recorded on the way."""
    root = tmp_path_factory.mktemp("init_test_pose")
    kw = dict(n_views=SCENE_VIEWS, image_size=max(SCENE_H, SCENE_W),
              niter=NITER, focal_avg=True)
    files = write_stage1_cloud(root / "jax")
    jpipe.run_init_test_pose(root / "jax", root / "jax_out",
                             oracle_pointmap_fn(files, jPairPrediction,
                                                with_test=True), **kw)
    files = write_stage1_cloud(root / "port")
    seen = {}
    mp = pytest.MonkeyPatch()
    register, get_poses = G.rigid_points_registration, \
        GlobalAligner.get_im_poses

    def spy_register(*a, **k):
        seen["sRT"] = register(*a, **k)
        return seen["sRT"]

    def spy_poses(self):
        seen["poses"] = get_poses(self)
        return seen["poses"]

    mp.setattr(G, "rigid_points_registration", spy_register)
    mp.setattr(GlobalAligner, "get_im_poses", spy_poses)
    timings = {}
    try:
        out = pipe.run_init_test_pose(
            root / "port", root / "port_out",
            oracle_pointmap_fn(files, PairPrediction, with_test=True),
            device="cpu", timings=timings, **kw)
    finally:
        mp.undo()
    return dict(root=root, out=out, seen=seen, timings=timings)


def _sparse1(root):
    return root / f"sparse_{SCENE_VIEWS}" / "1"


def test_run_init_test_pose_writes_jax_sparse_1(runs):
    a, b = _sparse1(runs["root"] / "jax"), _sparse1(runs["root"] / "port")
    for reader, f in ((colmap.read_images_text, "images.txt"),
                      (colmap.read_images_binary, "images.bin")):
        ia, ib = reader(a / f), reader(b / f)
        assert [im.name for im in ia.values()] == \
            [im.name for im in ib.values()]
        assert len(ia) == 12
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
    for root in ("jax_out", "port_out"):
        text = (runs["root"] / root / "train_time.txt").read_text()
        assert "[3] init_test_pose" in text
    assert set(runs["timings"]) == {"load", "inference", "init_mst",
                                    "align", "write", "scale"}


def test_transport_keeps_the_reference_quirk(runs):
    """[R, s*T]: only the translation column carries the registration
    scale. With s far from 1 the similarity transport [s*R, T] on the
    camera centres would differ."""
    s, R, Tr = runs["seen"]["sRT"]
    assert abs(s - 1.0) > 0.2, s
    assert s == pytest.approx(runs["timings"]["scale"])
    test_n1 = runs["seen"]["poses"][SCENE_VIEWS:]
    want = np.eye(4)
    want[:3, :3], want[:3, 3] = R, np.asarray(Tr).ravel() * s
    np.testing.assert_allclose(runs["out"], want @ test_n1, rtol=0,
                               atol=1e-12)
    sim3 = G.sRT_to_4x4(s, R, Tr)
    centres = (sim3 @ test_n1)[:, :3, 3]
    assert np.abs(centres - runs["out"][:, :3, 3]).max() > 1e-2
    # what was written is the inverse of the transported poses
    ims = colmap.read_images_text(_sparse1(runs["root"] / "port")
                                  / "images.txt")
    w2c = np.stack([im.w2c for im in ims.values()])
    np.testing.assert_allclose(w2c, np.linalg.inv(runs["out"]), atol=1e-5)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_parser_takes_jax_flags_with_jax_defaults():
    from instantsplat_tpu.cli import init_test_pose as jcli

    ours, theirs = itp_cli.build_parser(), jcli.build_parser()

    def flags(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type)
                for a in p._actions if a.dest != "help"}

    f_ours, f_theirs = flags(ours), flags(theirs)
    assert f_ours.keys() == f_theirs.keys()
    for k in f_theirs:
        if k != "device":
            assert f_ours[k] == f_theirs[k], k
    argv = ["-s", "a", "-m", "b", "--focal_avg", "--ckpt_path", "random:0"]
    a, b = vars(ours.parse_args(argv)), vars(theirs.parse_args(argv))
    assert a.pop("device") == "cuda" and b.pop("device") == "tpu"
    assert a == b
    with pytest.raises(SystemExit):
        ours.parse_args(argv + ["--device", "tpu"])


def test_cli_runs_on_cpu_and_needs_a_card_by_default(tmp_path, monkeypatch):
    write_stage1_cloud(tmp_path / "scene")
    argv = ["-s", str(tmp_path / "scene"), "-m", str(tmp_path / "out"),
            "--n_views", "3", "--ckpt_path", "random:0", "--image_size",
            "64", "--niter", "5", "--focal_avg"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            itp_cli.main(argv)
    built = []
    build = mast3r.build_model

    def tiny(ckpt_path, cfg, **kw):  # the full ViT-L is for the card
        model = build(ckpt_path, TINY, **kw)
        built.append((ckpt_path, cfg, model.dtype))
        return model

    monkeypatch.setattr(mast3r, "build_model", tiny)
    timings = itp_cli.main(argv + ["--device", "cpu"])
    # float32: the JAX CLI passes no dtype
    assert built == [("random:0", mast3r.MASt3RConfig(), torch.float32)]
    ims = colmap.read_images_text(tmp_path / "scene" / "sparse_3" / "1"
                                  / "images.txt")
    assert len(ims) == 12
    assert all(np.isfinite(im.w2c).all() for im in ims.values())
    cams = colmap.read_cameras_text(tmp_path / "scene" / "sparse_3" / "1"
                                    / "cameras.txt")
    assert all(c.params[0] == pytest.approx(SCENE_FOCAL)
               for c in cams.values())
    assert {"load", "inference", "init_mst", "align", "write"} <= set(
        timings)
