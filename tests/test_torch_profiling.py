"""The port's torch.profiler traces (utils/profiling.py) and
TrainerConfig.profile_dir, on the CPU, as tests/test_components.py holds
the JAX package's: a traced region leaves a trace file with its
`annotate` spans in it, a disabled trace does nothing, and train_joint
traces its second block. Unlike JAX's, nothing degrades to a no-op: a
trace that cannot be written raises."""

import json

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.data.scene import read_scene
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.utils.profiling import annotate, profile_trace
from torch_scenes import write_tiny_scene

torch.set_num_threads(2)


def _spans(logdir):
    """{trace file name: the names of its events}."""
    out = {}
    for path in logdir.glob("*.pt.trace.json"):
        events = json.loads(path.read_text())["traceEvents"]
        out[path.name] = {e.get("name") for e in events}
    return out


def test_profile_trace_writes_annotated_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(logdir):
        with annotate("golden-matmul"):
            a = torch.ones(64, 64)
            (a @ a).sum()
    (names,) = _spans(logdir).values()
    assert "golden-matmul" in names
    assert any(str(n).startswith("aten::mm") for n in names)

    with profile_trace(None):  # disabled: a clean no-op
        pass
    with profile_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_profile_trace_that_cannot_be_written_raises(tmp_path):
    taken = tmp_path / "a_file"
    taken.write_text("")
    with pytest.raises(OSError):
        with profile_trace(taken):
            pass


def test_train_joint_profile_dir_traces_block_one(tmp_path):
    """Blocks of log_every = 2: block 0 holds iterations 1-2 (on a card
    the warm-up), block 1 iterations 3-4, which alone are traced."""
    root = tmp_path / "scene"
    write_tiny_scene(root)
    info = read_scene(root, 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=0, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    logdir = tmp_path / "prof"
    _, _, hist = train_joint(
        g, info.cameras, OptimizationConfig(optim_pose=False),
        TrainerConfig(iterations=6, log_every=2, backend="pallas",
                      profile_dir=str(logdir)),
        spatial_lr_scale=info.nerf_radius)
    assert [it for it, _ in hist] == [2, 4, 6]
    assert np.isfinite(hist[-1][1]["loss"])
    (names,) = _spans(logdir).values()
    assert "train_joint block 3-4" in names
    assert not {"train_joint block 1-2", "train_joint block 5-6"} & names
