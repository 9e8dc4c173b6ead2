"""Pose trajectory visualization (matplotlib 3D; a copy of
instantsplat_tpu/eval/pose_viz.py). matplotlib is imported inside each
function: where it is missing the callers print that the plot was skipped.

Equivalent of the reference's `plot_pose`
(utils/utils_poses/vis_pose_utils.py:177-235, built on the evo library):
sim3-align the estimated trajectory onto the ground truth and plot both as
3D curves — 'Ours (aligned)' solid red, 'Ground-truth' dashed blue — saved
as poses_optimized.png next to the pose files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.eval.pose_metrics import align_ate_c2b_use_a2b


def plot_pose(ref_poses, est_poses, output_path, aligned=True):
    """ref/est: [N,4,4] c2w. Writes a 3D trajectory comparison png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ref = np.asarray(ref_poses, np.float64)
    est = np.asarray(est_poses, np.float64)
    if aligned:
        est = align_ate_c2b_use_a2b(est, ref)

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.xaxis.set_tick_params(labelbottom=False)
    ax.yaxis.set_tick_params(labelleft=False)
    ax.zaxis.set_tick_params(labelleft=False)
    for traj, style, color, label in [
        (est, "-", "r", "Ours (aligned)"),
        (ref, "--", "b", "Ground-truth"),
    ]:
        c = traj[:, :3, 3]
        ax.plot(c[:, 0], c[:, 1], c[:, 2], style, color=color, label=label)
    ax.legend()
    ax.view_init(elev=10.0, azim=45)
    plt.tight_layout()
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return str(out)


def visualize_cameras(poses, colors, output_path):
    """Simple camera-center scatter (reference `visualizer`,
    utils/vis_utils or render.py usage) — one dot per pose."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.asarray(poses)
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    c = poses[:, :3, 3]
    ax.scatter(c[:, 0], c[:, 1], c[:, 2], c=colors)
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return str(out)
