"""Stage-1 inputs for the port's tests, with no JAX, so that the tests
that need a card can use them too.

- `TINY`: tests/test_mast3r.py's tiny MASt3R configuration, as the port's
  config;
- `fake_upstream_sd`: a copy of tests/test_mast3r.py's synthetic state
  dict with AsymmetricMASt3R naming (same seed, same draws);
- `aligner_case`: scripts/make_goldens.py's `build_aligner_case` inputs
  (a fixed synthetic arc scene), and `run_aligner_case` running them
  through the port's aligner.
"""

import numpy as np

from instantsplat_tpu_torch.init.aligner import GlobalAligner, PairPrediction
from instantsplat_tpu_torch.init.pairs import make_pair_indices
from instantsplat_tpu_torch.models.mast3r import MASt3RConfig

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
