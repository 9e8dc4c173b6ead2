"""Stage-1 inputs for the port's tests, with no JAX, so that the tests
that need a card can use them too.

- `TINY`: tests/test_mast3r.py's tiny MASt3R configuration, as the port's
  config;
- `fake_upstream_sd`: a copy of tests/test_mast3r.py's synthetic state
  dict with AsymmetricMASt3R naming (same seed, same draws);
- `aligner_case`: scripts/make_goldens.py's `build_aligner_case` inputs
  (a fixed synthetic arc scene), and `run_aligner_case` running them
  through the port's aligner;
- the oracle scene of the stage-1 tests: `scene_geometry` (a copy of
  tests/test_pipeline_e2e.py's `_scene_geometry`, 14 views of a textured
  plane at 48x64), `write_oracle_scene` (its PNG frames) and
  `oracle_pointmap_fn` (its exact pointmaps plus seeded noise, for the
  train views or for the train and test views together), and
  `write_stage1_cloud`, the sparse_3/0 that init_test_pose reads.
"""

import numpy as np

from instantsplat_tpu_torch.data import images, scene
from instantsplat_tpu_torch.init.aligner import GlobalAligner, PairPrediction
from instantsplat_tpu_torch.init.pairs import make_pair_indices
from instantsplat_tpu_torch.models.mast3r import MASt3RConfig
from instantsplat_tpu_torch.utils import transforms as T

TINY = MASt3RConfig(
    patch_size=16,
    enc_embed_dim=64,
    enc_depth=2,
    enc_num_heads=2,
    dec_embed_dim=48,
    dec_depth=12,  # dpt hooks need dec_depth (uses 0, 6, 9, 12)
    dec_num_heads=2,
    local_feat_dim=24,
    dpt_layer_dims=(8, 16, 24, 32),
    dpt_feature_dim=16,
    dpt_last_dim=8,
)


def fake_upstream_sd(cfg):
    """Synthetic state_dict with AsymmetricMASt3R naming (numpy values);
    dec_blocks only, so a loader must apply the duplication rule."""
    rng = np.random.default_rng(0)
    sd = {}

    def lin(name, din, dout):
        sd[f"{name}.weight"] = rng.standard_normal(
            (dout, din)).astype(np.float32) * 0.02
        sd[f"{name}.bias"] = rng.standard_normal(dout).astype(np.float32)

    def ln(name, d):
        sd[f"{name}.weight"] = np.ones(d, np.float32)
        sd[f"{name}.bias"] = np.zeros(d, np.float32)

    def conv(name, cout, cin, k, bias=True, transpose=False):
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        sd[f"{name}.weight"] = rng.standard_normal(
            shape).astype(np.float32) * 0.02
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(cout).astype(np.float32)

    de, dd = cfg.enc_embed_dim, cfg.dec_embed_dim
    conv("patch_embed.proj", de, 3, cfg.patch_size)
    for i in range(cfg.enc_depth):
        p = f"enc_blocks.{i}"
        ln(f"{p}.norm1", de)
        lin(f"{p}.attn.qkv", de, 3 * de)
        lin(f"{p}.attn.proj", de, de)
        ln(f"{p}.norm2", de)
        lin(f"{p}.mlp.fc1", de, 4 * de)
        lin(f"{p}.mlp.fc2", 4 * de, de)
    ln("enc_norm", de)
    lin("decoder_embed", de, dd)
    for i in range(cfg.dec_depth):
        p = f"dec_blocks.{i}"
        ln(f"{p}.norm1", dd)
        lin(f"{p}.attn.qkv", dd, 3 * dd)
        lin(f"{p}.attn.proj", dd, dd)
        ln(f"{p}.norm2", dd)
        ln(f"{p}.norm3", dd)
        ln(f"{p}.norm_y", dd)
        for nm in ("projq", "projk", "projv", "proj"):
            lin(f"{p}.cross_attn.{nm}", dd, dd)
        lin(f"{p}.mlp.fc1", dd, 4 * dd)
        lin(f"{p}.mlp.fc2", 4 * dd, dd)
    ln("dec_norm", dd)
    for n in (1, 2):
        p = f"downstream_head{n}"
        ld = cfg.dpt_layer_dims
        fd = cfg.dpt_feature_dim
        for i, (dt, d) in enumerate(zip(cfg.dpt_dim_tokens, ld)):
            conv(f"{p}.dpt.act_postprocess.{i}.0", d, dt, 1)
            if i == 0:
                conv(f"{p}.dpt.act_postprocess.{i}.1", d, d, 4,
                     transpose=True)
            elif i == 1:
                conv(f"{p}.dpt.act_postprocess.{i}.1", d, d, 2,
                     transpose=True)
            elif i == 3:
                conv(f"{p}.dpt.act_postprocess.{i}.1", d, d, 3)
        for i, d in enumerate(ld):
            conv(f"{p}.dpt.scratch.layer{i + 1}_rn", fd, d, 3, bias=False)
        for i in range(4):
            rp = f"{p}.dpt.scratch.refinenet{i + 1}"
            conv(f"{rp}.resConfUnit1.conv1", fd, fd, 3)
            conv(f"{rp}.resConfUnit1.conv2", fd, fd, 3)
            conv(f"{rp}.resConfUnit2.conv1", fd, fd, 3)
            conv(f"{rp}.resConfUnit2.conv2", fd, fd, 3)
            conv(f"{rp}.out_conv", fd, fd, 1)
        conv(f"{p}.dpt.head.0", cfg.dpt_last_dim, fd, 3)
        conv(f"{p}.dpt.head.2", 4, cfg.dpt_last_dim, 1)
        idim = de + dd
        n_out = (cfg.local_feat_dim + 1) * cfg.patch_size**2
        lin(f"{p}.head_local_features.fc1", idim, 4 * idim)
        lin(f"{p}.head_local_features.fc2", 4 * idim, n_out)
    return sd


def aligner_case():
    """The golden aligner case's PairPrediction: a 3-view arc of a plane
    at z = 3, 24x32 pointmaps with seeded noise and confidences."""
    n_views, h, w, focal = 3, 24, 32, 40.0
    rng = np.random.default_rng(7)
    c2w = []
    for v in range(n_views):
        ang = 0.12 * (v - (n_views - 1) / 2)
        c, s = np.cos(ang), np.sin(ang)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        m[:3, 3] = [2.0 * np.sin(ang), 0.0, -2.0 * (1 - np.cos(ang))]
        c2w.append(m)
    c2w = np.stack(c2w)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(gx - w / 2) / focal, (gy - h / 2) / focal,
                     np.ones_like(gx)], -1)
    pts_world, pts_cam = [], []
    for v in range(n_views):
        Rv, tv = c2w[v, :3, :3], c2w[v, :3, 3]
        dw = dirs @ Rv.T
        lam = (3.0 - tv[2]) / dw[..., 2]
        pw = tv + lam[..., None] * dw
        pts_world.append(pw)
        pts_cam.append((pw - tv) @ Rv)
    pts_world, pts_cam = np.stack(pts_world), np.stack(pts_cam)
    edges = make_pair_indices(n_views, "complete", symmetrize=True)
    noise = 0.01 * rng.standard_normal((len(edges), h, w, 3))
    pred_i = np.stack([pts_cam[i] for i, j in edges]) + noise
    pred_j = np.stack([
        (pts_world[j] - c2w[i, :3, 3]) @ c2w[i, :3, :3] for i, j in edges
    ]) + noise[::-1]
    conf = 1.0 + np.exp(rng.random((len(edges), h, w)) * 2)
    return PairPrediction(edges=edges,
                          pred_i=pred_i.astype(np.float32),
                          pred_j=pred_j.astype(np.float32),
                          conf_i=conf.astype(np.float32),
                          conf_j=conf.astype(np.float32) * 1.05)


def run_aligner_case(device="cpu", niter=30):
    """init_mst(focal_avg=True) + `niter` iterations of align on
    `device` -> dict(poses, focals, loss) as the golden file holds."""
    al = GlobalAligner(aligner_case(), device=device)
    al.init_mst(focal_avg=True)
    loss = al.align(niter=niter)
    return dict(poses=np.asarray(al.get_im_poses(), np.float64),
                focals=np.asarray(al.get_focals(), np.float64),
                loss=np.float64(loss))


# tests/test_pipeline_e2e.py's oracle scene
SCENE_H, SCENE_W = 48, 64
SCENE_FOCAL = 50.0
SCENE_IMAGES = 14
SCENE_VIEWS = 3


def scene_geometry(h=SCENE_H, w=SCENE_W):
    """c2w poses + per-view (world points, camera points, image) of 14
    views along an arc in front of a textured plane at z = 3."""
    def rot_y(a):
        return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                         [-np.sin(a), 0, np.cos(a)]])

    def texture(x, y):
        r = 0.5 + 0.45 * np.sin(2.2 * x) * np.cos(1.7 * y)
        g = 0.5 + 0.45 * np.sin(1.3 * x + 1.0) * np.sin(2.9 * y)
        b = 0.5 + 0.45 * np.cos(2.0 * x - 0.5) * np.cos(1.1 * y + 0.3)
        return np.stack([r, g, b], -1)

    c2ws, pts_world, pts_cam, imgs = [], [], [], []
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    dirs = np.stack([(gx - w / 2) / SCENE_FOCAL, (gy - h / 2) / SCENE_FOCAL,
                     np.ones_like(gx)], -1)
    for v in range(SCENE_IMAGES):
        ang = 0.05 * (v - (SCENE_IMAGES - 1) / 2)
        R = rot_y(ang)
        center = np.array([1.5 * np.sin(ang), 0.02 * v,
                           -1.5 * (1 - np.cos(ang))])
        m = np.eye(4)
        m[:3, :3] = R
        m[:3, 3] = center
        c2ws.append(m)
        d_world = dirs @ R.T
        lam = (3.0 - center[2]) / d_world[..., 2]
        pw = center + lam[..., None] * d_world
        pts_world.append(pw)
        pts_cam.append((pw - center) @ R)
        imgs.append(texture(pw[..., 0], pw[..., 1]))
    return np.stack(c2ws), np.stack(pts_world), np.stack(pts_cam), \
        np.stack(imgs)


def write_oracle_scene(root):
    """The scene's 14 frames as PNGs under root/images -> their names."""
    (root / "images").mkdir(parents=True)
    _, _, _, imgs = scene_geometry()
    for v in range(SCENE_IMAGES):
        images.save_image(root / "images" / f"frame_{v:04d}.png", imgs[v])
    return [f"frame_{v:04d}.png" for v in range(SCENE_IMAGES)]


def oracle_pointmap_fn(files, cls, with_test=False, noise=0.01):
    """pointmap_fn(images, pairs) -> `cls` (either package's
    PairPrediction) of the scene's exact pointmaps plus seeded noise.
    Image k of the pairs is split_train_test's k-th train view, then (with
    `with_test`, as init_test_pose orders them) its test views.

    The noise (0.01) matters: exact pointmaps start the aligner at the
    rounding floor of its loss, where the gradients' signs are rounding
    noise that Adam turns into whole steps, so no two implementations
    follow one path from there."""
    c2ws, pts_world, pts_cam, _ = scene_geometry()
    _, _, train_idx, test_idx = scene.split_train_test(files, SCENE_VIEWS)
    frames = list(train_idx) + ([int(k) for k in test_idx]
                                if with_test else [])

    def fn(imgs, pairs):
        rng = np.random.default_rng(0)
        t = [frames[i] for i, _ in pairs], [frames[j] for _, j in pairs]
        pred_i = pts_cam[t[0]]
        pred_j = np.einsum("eni,eij->enj", (pts_world[t[1]] - c2ws[
            t[0], None, None, :3, 3]).reshape(len(pairs), -1, 3),
            c2ws[t[0], :3, :3]).reshape(pred_i.shape)
        conf = 1.0 + np.exp(rng.random(pred_i.shape[:3]).astype(np.float32))
        eps = noise * rng.standard_normal((2,) + pred_i.shape)
        return cls(edges=list(pairs),
                   pred_i=(pred_i + eps[0]).astype(np.float32),
                   pred_j=(pred_j + eps[1]).astype(np.float32),
                   conf_i=conf, conf_j=conf * 1.05)

    return fn


def write_stage1_cloud(root, scale=1.0, shift=(0.3, 0.3, 0.3)):
    """The oracle scene's frames plus sparse_3/0 as stage 1 leaves it for
    init_test_pose: `points3D_all.npy`, the train views' true points turned
    by 0.3 rad about y, scaled by `scale` and moved by `shift`, and
    `non_scaled_focals.npy`, the true focals. -> the frames' names."""
    files = write_oracle_scene(root)
    _, sparse_0, _ = scene.init_filestructure(root, SCENE_VIEWS)
    _, pts_world, _, _ = scene_geometry()
    _, _, train_idx, _ = scene.split_train_test(files, SCENE_VIEWS)
    R = T.qvec_to_rotmat(np.array([np.cos(0.15), 0.0, np.sin(0.15), 0.0]))
    pts = scale * pts_world[train_idx] @ R.T + np.array(shift)
    np.save(sparse_0 / "points3D_all.npy", pts.astype(np.float32))
    np.save(sparse_0 / "non_scaled_focals.npy",
            np.full(SCENE_VIEWS, SCENE_FOCAL, np.float32))
    return files


def _rot(axis, angle):
    axis = np.asarray(axis, float)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def sparse_scene(cls, n_views=3, h=24, w=32, focal=40.0, seed=0):
    """tests/test_aligner.py's `_synthetic_scene`: cameras on an arc
    looking at the plane z = 3, exact pairwise pointmaps, as `cls` (either
    package's PairPrediction) -> (c2w, focal, preds)."""
    rng = np.random.default_rng(seed)
    c2w = []
    for v in range(n_views):
        ang = 0.12 * (v - (n_views - 1) / 2)
        m = np.eye(4)
        m[:3, :3] = _rot([0, 1, 0], ang)
        m[:3, 3] = [2.0 * np.sin(ang), 0.0, -2.0 * (1 - np.cos(ang))]
        c2w.append(m)
    c2w = np.stack(c2w)
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    dirs_cam = np.stack(
        [(gx - w / 2) / focal, (gy - h / 2) / focal, np.ones_like(gx)], -1)
    pts_world, pts_cam = [], []
    for v in range(n_views):
        Rv, tv = c2w[v, :3, :3], c2w[v, :3, 3]
        d_world = dirs_cam @ Rv.T
        lam = (3.0 - tv[2]) / d_world[..., 2]
        pw = tv + lam[..., None] * d_world
        pts_world.append(pw)
        pts_cam.append((pw - tv) @ Rv)
    edges = make_pair_indices(n_views, "complete", symmetrize=True)
    pred_i = np.stack([pts_cam[i] for i, j in edges]).astype(np.float32)
    pred_j = np.stack([
        (pts_world[j] - c2w[i, :3, 3]) @ c2w[i, :3, :3] for i, j in edges
    ]).astype(np.float32)
    conf = 1.0 + np.exp(rng.random((len(edges), h, w)).astype(np.float32))
    return c2w, focal, cls(edges=edges, pred_i=pred_i, pred_j=pred_j,
                           conf_i=conf, conf_j=conf * 1.1)


def world_desc(pts_in_frame, c2w_i):
    """tests/test_aligner.py's descriptors: a smooth, injective,
    unit-normalised function of the WORLD point, so corresponding pixels
    share descriptors."""
    world = pts_in_frame @ c2w_i[:3, :3].T + c2w_i[:3, 3]
    x, y = world[..., 0], world[..., 1]
    f = np.stack([x, y, np.sin(0.5 * x), np.cos(0.4 * y),
                  np.sin(0.3 * (x + y)), np.ones_like(x)], -1)
    return (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(np.float32)


def attach_world_desc(preds, c2w):
    """preds.desc_i / desc_j from `world_desc` of the true poses."""
    preds.desc_i = np.stack([world_desc(preds.pred_i[e], c2w[i])
                             for e, (i, j) in enumerate(preds.edges)])
    preds.desc_j = np.stack([world_desc(preds.pred_j[e], c2w[i])
                             for e, (i, j) in enumerate(preds.edges)])
    return preds


def relative_pose_error(c2w_a, c2w_b):
    """tests/test_aligner.py's `_relative_pose_error`: max rotation angle
    (rad) and normalised translation error over all relative poses."""
    n = len(c2w_a)
    rot_err, t_err = 0.0, 0.0
    ca = np.stack([m[:3, 3] for m in c2w_a])
    cb = np.stack([m[:3, 3] for m in c2w_b])
    sa = np.linalg.norm(ca - ca.mean(0), axis=1).mean() + 1e-12
    sb = np.linalg.norm(cb - cb.mean(0), axis=1).mean() + 1e-12
    for i in range(n):
        for j in range(i + 1, n):
            Ra = c2w_a[i][:3, :3].T @ c2w_a[j][:3, :3]
            Rb = c2w_b[i][:3, :3].T @ c2w_b[j][:3, :3]
            cos = (np.trace(Ra.T @ Rb) - 1) / 2
            rot_err = max(rot_err, np.arccos(np.clip(cos, -1, 1)))
            ta = c2w_a[i][:3, :3].T @ (ca[j] - ca[i]) / sa
            tb = c2w_b[i][:3, :3].T @ (cb[j] - cb[i]) / sb
            t_err = max(t_err, np.linalg.norm(ta - tb))
    return rot_err, t_err
