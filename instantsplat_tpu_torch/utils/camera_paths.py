"""Camera path generation: B-spline pose interpolation + lookat frames
(a copy of instantsplat_tpu/utils/camera_paths.py; numpy and scipy only).

Reference behavior: utils/camera_utils.py:89-182 (`generate_interpolated_path`,
`transform_poses_pca`) and utils/pose_utils.py:302-417 (ellipse/spiral render
paths) — the smooth camera trajectories used for (a) pre-initializing
test-view poses from interpolated train poses (init_geo.py:86-115) and
(b) the 30 fps novel-view video sweep (render.py:36-76).

The spline runs over poses encoded as (position, lookat-point, up-point)
anchor triplets so rotation interpolates through geometry rather than
quaternion space; identical parameters (degree 5, smoothness 0.03,
rot_weight 0.1). All frame construction here is batched numpy — camera
bookkeeping stays off the device.
"""

from __future__ import annotations

import numpy as np
import scipy.interpolate


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def camera_frames(eyes, lookdirs, verticals):
    """Batched OpenGL-style camera frames.

    Every argument is [..., 3] (broadcastable against each other). Returns
    [..., 3, 4] pose blocks whose columns are (right, up, back, eye) with
    back = unit(lookdir) — the camera's +z points *away* from what it looks
    at, matching the reference viewmatrix convention
    (utils/camera_utils.py:206-214 semantics).
    """
    eyes, lookdirs, verticals = np.broadcast_arrays(
        *(np.asarray(a, dtype=float) for a in (eyes, lookdirs, verticals)))
    back = _unit(lookdirs)
    right = _unit(np.cross(verticals, back))
    up = _unit(np.cross(back, right))
    return np.concatenate(
        [np.stack([right, up, back], axis=-1), eyes[..., None]], axis=-1)


def _homogeneous(p):
    """Append the constant [0,0,0,1] row to [..., 3, 4] pose blocks."""
    bottom = np.zeros_like(p[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return np.concatenate([p, bottom], axis=-2)


def generate_interpolated_path(poses, n_interp, spline_degree=5,
                               smoothness=0.03, rot_weight=0.1):
    """Smooth B-spline through [N,3,4] (or [N,4,4]) c2w pose keyframes.

    Each keyframe is encoded as three 3D anchors — the eye plus probe
    points offset rot_weight along the view (-z) and vertical (+y) axes —
    and one multidimensional spline is fit through the 9-vector sequence
    (reference: camera_utils.py:127-182). Returns [n_interp * (N-1), 3, 4].
    """
    poses = np.asarray(poses, dtype=float)[:, :3, :4]
    eyes = poses[:, :, 3]
    anchors = np.stack([
        eyes,
        eyes - rot_weight * poses[:, :, 2],   # lookat probe (along view dir)
        eyes + rot_weight * poses[:, :, 1],   # up probe
    ], axis=1)                                # [N, 3 anchors, 3]

    n_out = n_interp * (len(poses) - 1)
    degree = min(spline_degree, len(poses) - 1)
    tck, _ = scipy.interpolate.splprep(
        anchors.reshape(len(poses), 9).T, k=degree, s=smoothness)
    u = np.linspace(0.0, 1.0, n_out, endpoint=False)
    samples = np.asarray(scipy.interpolate.splev(u, tck)).T  # [n_out, 9]
    eye_s, look_s, up_s = samples.reshape(n_out, 3, 3).transpose(1, 0, 2)
    return camera_frames(eye_s, eye_s - look_s, up_s - eye_s)


def interpolate_between_all(poses, n_interp):
    """Chain pairwise interpolation over consecutive keyframes and append
    the final keyframe — the pattern used by both init_geo.py:93-101 and
    render.py:36-57. poses: [N,4,4] (or [N,3,4]); returns [M,4,4]."""
    poses = np.asarray(poses)
    segs = [
        generate_interpolated_path(poses[i:i + 2], n_interp)
        for i in range(len(poses) - 1)
    ]
    allp = np.concatenate(segs + [poses[-1:, :3, :4]], axis=0)
    out = np.tile(np.eye(4), (len(allp), 1, 1))
    out[:, :3, :4] = allp
    return out


def video_path_from_train_poses(poses_w2c, n_views, seconds=10, fps=30):
    """render.py:36-57: n_interp = int(seconds * fps / n_views) between
    each consecutive optimized pose. Returns [M,4,4] (same convention as
    the input poses)."""
    n_interp = int(seconds * fps / n_views)
    return interpolate_between_all(np.asarray(poses_w2c), n_interp)


def test_pose_init_from_train(extrinsics_w2c, n_test):
    """init_geo.py:86-113: spline-interpolate the train w2c extrinsics and
    linspace-sample n_test of them (or subsample directly when there are
    enough train views)."""
    extr = np.asarray(extrinsics_w2c)
    n_train = len(extr)
    if n_train < n_test:
        n_interp = (n_test // (n_train - 1)) + 1
        allp = interpolate_between_all(extr, n_interp)
        idx = np.linspace(0, len(allp) - 1, n_test, dtype=int)
        return allp[idx]
    idx = np.linspace(0, n_train - 1, n_test, dtype=int)
    return extr[idx]


# ---------------------------------------------------------------------------
# pose normalization + ellipse / spiral render paths
# (reference behavior: utils/camera_utils.py:89-125, utils/pose_utils.py:302-417)
# ---------------------------------------------------------------------------


def transform_poses_pca(poses):
    """Rotate/scale the world so camera centers' principal axes land on
    XYZ and all centers fit in [-1,1]^3 (camera_utils.py:89-125 behavior).

    poses: [N,3,4] (or [N,4,4]) c2w. Returns (aligned [N,3,4], world
    transform [4,4] mapping original world coords into the aligned frame).
    """
    poses = np.asarray(poses, dtype=float)[:, :3, :4]
    eyes = poses[:, :, 3]
    centroid = eyes.mean(axis=0)
    scatter = (eyes - centroid).T @ (eyes - centroid)
    # np.linalg.eig (not eigh/svd) keeps eigenvector sign conventions
    # matching the normalization downstream consumers were tuned on.
    evals, evecs = np.linalg.eig(scatter)
    basis = evecs[:, np.argsort(evals)[::-1]].T
    if np.linalg.det(basis) < 0:
        basis[2] *= -1.0                     # keep it a rotation

    world_tf = np.eye(4)
    world_tf[:3, :3] = basis
    world_tf[:3, 3] = basis @ -centroid
    aligned = np.einsum('ij,njk->nik', world_tf[:3], _homogeneous(poses))

    # Keep the average camera up-axis (+y column) pointing toward +z.
    if aligned[:, 2, 1].mean() < 0:
        row_signs = np.array([1.0, -1.0, -1.0])
        aligned = aligned * row_signs[:, None]
        world_tf[:3] *= row_signs[:, None]

    span = np.abs(aligned[:, :, 3]).max()
    aligned[:, :, 3] /= span
    world_tf[:3] /= span
    return aligned, world_tf


def focus_point_fn(poses):
    """Least-squares point closest to every camera's optical axis
    (pose_utils.py:292-299 behavior). poses: [N,3+,4] aligned c2w."""
    axes = poses[:, :3, 2]
    eyes = poses[:, :3, 3]
    # Rejection matrix I - zz^T projects onto each axis' normal plane;
    # summing the per-camera normal equations gives the closest point.
    reject = np.eye(3) - axes[:, :, None] * axes[:, None, :]
    return np.linalg.solve(reject.sum(0), np.einsum('nij,nj->i', reject, eyes))


def generate_ellipse_path(c2w_poses, n_frames=600, const_speed=True,
                          z_variation=0.0, z_phase=0.0):
    """Elliptical orbit around the scene focus point
    (pose_utils.py:302-366 behavior). c2w_poses: [N,4,4] (COLMAP
    convention); returns [n_frames, 4, 4] w2c matrices ready for rendering.
    """
    from instantsplat_tpu_torch.utils.stepfun import sample_np

    # COLMAP -> OpenGL axis convention, then PCA-normalize the capture.
    gl = np.asarray(c2w_poses, dtype=float).copy()
    gl[:, :3, 1:3] *= -1
    poses, world_tf = transform_poses_pca(gl)

    center = focus_point_fn(poses)
    eyes = poses[:, :, 3]
    # Orbit in the z=0 plane about the focus point's xy; radii from the
    # 90th-percentile spread of the (aligned) camera centers.
    ring_center = np.array([center[0], center[1], 0.0])
    radius = np.percentile(np.abs(eyes - ring_center), 90, axis=0)
    z_lo, z_hi = np.percentile(eyes, [10, 90], axis=0)[:, 2]

    def orbit(theta):
        return np.stack([
            ring_center[0] + radius[0] * np.cos(theta),
            ring_center[1] + radius[1] * np.sin(theta),
            z_variation * (z_lo + (z_hi - z_lo)
                           * (0.5 + 0.5 * np.cos(theta + 2 * np.pi * z_phase))),
        ], axis=-1)

    theta = np.linspace(0.0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = orbit(theta)
    if const_speed:
        seglen = np.linalg.norm(np.diff(positions, axis=0), axis=-1)
        theta = sample_np(None, theta, np.log(np.maximum(seglen, 1e-12)),
                          n_frames + 1)
        positions = orbit(theta)
    positions = positions[:-1]               # drop the wrapped duplicate

    # World up = the dominant axis of the mean camera up direction.
    mean_up = _unit(poses[:, :3, 1].mean(0))
    dom = np.argmax(np.abs(mean_up))
    up = np.sign(mean_up[dom]) * np.eye(3)[dom]

    frames = camera_frames(positions, positions - center, up)
    c2w = np.linalg.inv(world_tf)[None] @ _homogeneous(frames)
    c2w[:, :3, 1:3] *= -1                    # back to COLMAP convention
    return np.linalg.inv(c2w)


def generate_spiral_path(c2w_poses, bounds, n_frames=180, n_rots=2,
                         zrate=0.5):
    """Forward-facing spiral (pose_utils.py:370-417 behavior, simplified to
    take [N,4,4] c2w + [N,2] near/far bounds). Returns [n_frames,4,4] w2c."""
    poses = np.asarray(c2w_poses, dtype=float).copy()[:, :3, :4]
    poses[:, :, 1:3] *= -1
    bounds = np.asarray(bounds)
    scale = 1.0 / (bounds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale
    poses, world_tf = transform_poses_pca(poses)

    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1 / ((1 - dt) / close_depth + dt / inf_depth)
    positions = poses[:, :3, 3]
    radii = np.concatenate(
        [np.percentile(np.abs(positions), 90, 0), [1.0]])

    cam2world = np.eye(4)
    cam2world[:3] = camera_frames(
        positions.mean(0), poses[:, :3, 2].mean(0), poses[:, :3, 1].mean(0))
    up = poses[:, :3, 1].mean(0)
    theta = np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False)
    offsets = radii * np.stack([np.cos(theta), -np.sin(theta),
                                -np.sin(theta * zrate),
                                np.ones_like(theta)], axis=-1)
    spiral_eyes = (offsets @ cam2world.T)[:, :3]
    lookat = (cam2world @ [0, 0, -focal, 1.0])[:3]

    frames = camera_frames(spiral_eyes, spiral_eyes - lookat, up)
    c2w = np.linalg.inv(world_tf)[None] @ _homogeneous(frames)
    c2w[:, :3, 1:3] *= -1
    c2w[:, :3, 3] /= scale
    return np.linalg.inv(c2w)
