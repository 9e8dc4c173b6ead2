"""Stage 2 as a whole: the port's run_training against the JAX one on a
tiny sparse_3 scene (64x48 PNGs, 500 points, SH 2), and the artifacts of
each package loaded by the other.

Same scene, seed and views: the per-iteration losses agree at rtol 1e-4 and
the final parameters and poses at rtol 1e-3 / atol 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from instantsplat_tpu.opt.gaussian_opt import (
    OptimizationConfig as JOptConfig,
)
from instantsplat_tpu.pipelines import train_pipeline as jpipe
from instantsplat_tpu.pipelines.config import ModelParams as JModelParams
from instantsplat_tpu.pipelines.trainer import TrainerConfig as JTrainerConfig
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines import train_pipeline as pipe
from instantsplat_tpu_torch.pipelines.config import ModelParams
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig
from torch_scenes import write_tiny_scene

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ITERS = 5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port run of ITERS iterations on the same scene."""
    root = tmp_path_factory.mktemp("slice")
    scene = root / "scene"
    write_tiny_scene(scene)
    kw = dict(sh_degree=2, source_path=str(scene), n_views=3)
    opt_kw = dict(pp_optimizer=True, optim_pose=True)
    tr_kw = dict(iterations=ITERS, backend="oracle", log_every=1)
    jparams, jhist = jpipe.run_training(
        JModelParams(model_path=str(root / "jax"), **kw),
        JOptConfig(**opt_kw), JTrainerConfig(**tr_kw),
        checkpoint_iterations=[ITERS])
    tparams, thist = pipe.run_training(
        ModelParams(model_path=str(root / "torch"), **kw),
        OptimizationConfig(**opt_kw), TrainerConfig(**tr_kw),
        checkpoint_iterations=[ITERS], device="cpu")
    return dict(root=root, scene=scene, jparams=jparams, jhist=jhist,
                tparams=tparams, thist=thist)


def test_loss_curve_matches_jax(runs):
    jl = [m["loss"] for _, m in runs["jhist"]]
    tl = [m["loss"] for _, m in runs["thist"]]
    assert [it for it, _ in runs["thist"]] == list(range(1, ITERS + 1))
    assert len(jl) == ITERS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    for key in ("l1", "ssim", "psnr"):
        np.testing.assert_allclose([m[key] for _, m in runs["thist"]],
                                   [m[key] for _, m in runs["jhist"]],
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("field", ["xyz", "features_dc", "features_rest",
                                   "opacity", "cam_poses"])
def test_run_training_params_match_jax(runs, field):
    """Scaling and rotation are compared in test_train_joint_matches_jax:
    create_from_pcd's exactly isotropic scales make some rotation (and,
    through it, scale) gradients zero up to rounding, and Adam (eps 1e-15)
    turns that rounding into whole steps whose sign each framework draws
    differently (ROADMAP.md queue 3)."""
    got = getattr(runs["tparams"], field).numpy()
    want = np.asarray(getattr(runs["jparams"], field))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def joint_runs(runs):
    """train_joint of both packages from the same non-degenerate start:
    the scene's Gaussians with seeded anisotropic scales, random rotations
    and opacities, so no gradient is zero only up to rounding."""
    from instantsplat_tpu.data.scene import read_scene as jread
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    from instantsplat_tpu.pipelines.trainer import train_joint as jtrain
    from instantsplat_tpu_torch.convert import gaussians_from_numpy, to_numpy
    from instantsplat_tpu_torch.data.scene import read_scene
    from instantsplat_tpu_torch.models.gaussians import GaussianModel
    from instantsplat_tpu_torch.pipelines.trainer import train_joint

    info = read_scene(runs["scene"], 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=2, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    arrays = to_numpy(g)
    rng = np.random.default_rng(11)
    n = g.num_points
    arrays["scaling"] = arrays["scaling"] + rng.normal(size=(n, 3)) * 0.3
    arrays["rotation"] = rng.normal(size=(n, 4))
    arrays["opacity"] = rng.normal(size=(n, 1))
    arrays = {k: np.asarray(v, np.float32) if k != "max_sh_degree" else v
              for k, v in arrays.items()}
    opt_kw = dict(pp_optimizer=True, optim_pose=True)
    tr_kw = dict(iterations=ITERS, backend="oracle", log_every=1)
    radius = info.nerf_radius

    jinfo = jread(runs["scene"], 3)
    import jax.numpy as jnp

    jp0 = JG(**{k: jnp.asarray(arrays[k]) for k in PARAM_FIELDS},
             max_sh_degree=2)
    jp, _, jhist = jtrain(jp0, jinfo.cameras, JOptConfig(**opt_kw),
                          JTrainerConfig(**tr_kw), spatial_lr_scale=radius)
    tp0 = gaussians_from_numpy(arrays, 2, device="cpu")
    tp, _, thist = train_joint(tp0, info.cameras, OptimizationConfig(
        **opt_kw), TrainerConfig(**tr_kw), spatial_lr_scale=radius)
    return jp, jhist, tp, thist


def test_train_joint_losses_match_jax(joint_runs):
    jp, jhist, tp, thist = joint_runs
    np.testing.assert_allclose([m["loss"] for _, m in thist],
                               [m["loss"] for _, m in jhist], rtol=1e-4)


@pytest.mark.parametrize("field", PARAM_FIELDS)
def test_train_joint_params_match_jax(joint_runs, field):
    jp, _, tp, _ = joint_runs
    np.testing.assert_allclose(getattr(tp, field).numpy(),
                               np.asarray(getattr(jp, field)), rtol=1e-3,
                               atol=1e-5)


def test_artifact_tree(runs):
    for tree in ("jax", "torch"):
        out = runs["root"] / tree
        for rel in (f"point_cloud/iteration_{ITERS}/point_cloud.ply",
                    f"pose/ours_{ITERS}/pose_org.npy",
                    f"pose/ours_{ITERS}/pose_optimized.npy",
                    f"ckpt/chkpnt{ITERS}.npz", "cameras.json", "cfg_args",
                    "train_time.txt", "scalars.jsonl", "input.ply"):
            assert (out / rel).is_file(), (tree, rel)
    a, b = (runs["root"] / t / "cameras.json" for t in ("jax", "torch"))
    assert a.read_text() == b.read_text()
    tj = (runs["root"] / "torch" / "scalars.jsonl").read_text().splitlines()
    assert len(tj) == ITERS * 5  # loss, l1, ssim, psnr, elapsed_s


def test_jax_loads_port_artifacts(runs):
    out = runs["root"] / "torch"
    params, it = jpipe.load_trained(out, -1, sh_degree=2)
    assert it == ITERS
    for f in PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(np.asarray(getattr(params, f)),
                                      getattr(runs["tparams"], f).numpy())
    poses = np.load(out / "pose" / f"ours_{ITERS}" / "pose_optimized.npy")
    jposes = np.load(runs["root"] / "jax" / "pose" / f"ours_{ITERS}"
                     / "pose_optimized.npy")
    np.testing.assert_allclose(poses, jposes, rtol=1e-3, atol=1e-5)
    jp, jstate, jit = jpipe.load_checkpoint(out / "ckpt"
                                            / f"chkpnt{ITERS}.npz")
    assert jit == ITERS and int(jstate.step) == ITERS
    np.testing.assert_array_equal(np.asarray(jp.cam_poses),
                                  runs["tparams"].cam_poses.numpy())


def test_port_loads_jax_artifacts(runs):
    out = runs["root"] / "jax"
    params, it = pipe.load_trained(out, -1, sh_degree=2, device="cpu")
    assert it == ITERS
    for f in PARAM_FIELDS[:-1]:
        np.testing.assert_array_equal(getattr(params, f).numpy(),
                                      np.asarray(getattr(runs["jparams"], f)))
    tp, state, tit = pipe.load_checkpoint(out / "ckpt" / f"chkpnt{ITERS}.npz",
                                          device="cpu")
    assert tit == ITERS and state.step == ITERS
    assert state.per_point_lr is not None
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(runs["jparams"], f)))


def test_checkpoint_keys_match_jax(runs):
    a = np.load(runs["root"] / "jax" / "ckpt" / f"chkpnt{ITERS}.npz")
    b = np.load(runs["root"] / "torch" / "ckpt" / f"chkpnt{ITERS}.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_port_resumes_from_jax_checkpoint(runs, tmp_path):
    """Resume the port from the JAX run's checkpoint for 2 more
    iterations: the Adam step count carries on and the history starts at
    the next iteration."""
    ckpt = runs["root"] / "jax" / "ckpt" / f"chkpnt{ITERS}.npz"
    params, hist = pipe.run_training(
        ModelParams(sh_degree=2, source_path=str(runs["scene"]), n_views=3,
                    model_path=str(tmp_path / "resumed")),
        OptimizationConfig(pp_optimizer=True, optim_pose=True),
        TrainerConfig(iterations=ITERS + 2, backend="oracle", log_every=1),
        checkpoint_iterations=[ITERS + 2], start_checkpoint=str(ckpt),
        device="cpu")
    assert [it for it, _ in hist] == [ITERS + 1, ITERS + 2]
    _, state, _ = pipe.load_checkpoint(
        tmp_path / "resumed" / "ckpt" / f"chkpnt{ITERS + 2}.npz",
        device="cpu")
    assert state.step == ITERS + 2
    assert np.isfinite([m["loss"] for _, m in hist]).all()


def test_cli_runs_on_cpu(runs, tmp_path):
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "instantsplat_tpu_torch.cli.train", "-s",
         str(runs["scene"]), "-m", str(out), "--n_views", "3",
         "--iterations", "2", "--sh_degree", "2", "--pp_optimizer",
         "--optim_pose", "--backend", "pallas", "--device", "cpu",
         "--log_every", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] iter 2: loss=" in proc.stdout
    assert (out / "point_cloud" / "iteration_2" / "point_cloud.ply").is_file()
    assert (out / "pose" / "ours_2" / "pose_optimized.npy").is_file()


def test_cuda_default_without_card_raises(runs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipe.run_training(
            ModelParams(sh_degree=2, source_path=str(runs["scene"]),
                        n_views=3, model_path=str(tmp_path / "x")),
            OptimizationConfig(), TrainerConfig(iterations=1))
