"""The port's sparse global alignment (init/sparse_align.py) against the
JAX package's, on the CPU.

- The host half (crop grid, crop-pair selection, coarse-to-fine
  refinement with tests/test_aligner.py's descriptor `infer_fn`, the MST)
  gives equal arrays.
- `sparse_global_alignment` on tests/test_aligner.py's three-view scene
  (copied in tests/torch_init_cases.py), 30 + 30 iterations, for the
  kinematic chain (a star and a chain through view 1) and free poses,
  each `anchor3d_mode`, with and without depth optimisation, and from a
  wrong focal: c2w within 1e-4, scales and focals rtol 1e-4, the final
  loss rtol 1e-4, the depth scales within 1e-4. The two packages sum
  gradients in different orders, and Adam turns those last bits into
  parts of a step, so longer runs drift apart (ROADMAP.md section 3).
- The port alone passes JAX's recovery gates at JAX's iteration counts.
"""

import numpy as np
import pytest
import torch

from instantsplat_tpu.init import aligner as jal
from instantsplat_tpu.init import sparse_align as jsa
from instantsplat_tpu_torch.init import aligner as al
from instantsplat_tpu_torch.init import sparse_align as sa
from instantsplat_tpu_torch.init.pairs import make_pair_indices
from torch_init_cases import (attach_world_desc, relative_pose_error,
                              sparse_scene)

torch.set_num_threads(2)


def _scenes(n_views=3):
    c2w, focal, jp = sparse_scene(jal.PairPrediction, n_views=n_views)
    _, _, tp = sparse_scene(al.PairPrediction, n_views=n_views)
    return c2w, focal, attach_world_desc(jp, c2w), attach_world_desc(tp, c2w)


def test_overlapping_grid_and_crop_selection():
    for args in ((96, 128, 64, 0.5), (384, 512, 256, 0.5), (50, 70, 48, 0.3)):
        np.testing.assert_array_equal(sa._overlapping_grid(*args),
                                      jsa._overlapping_grid(*args))
    rng = np.random.default_rng(0)
    blob1 = rng.uniform([5, 5], [40, 40], (30, 2))
    blob2 = rng.uniform([80, 50], [120, 90], (30, 2))
    xy1 = np.concatenate([blob1, blob2])
    xy2 = xy1 + [4.0, 2.0]
    for maxdim in (48, 64):
        got = sa.select_pairs_of_crops((96, 128), (96, 128), xy1, xy2,
                                       maxdim=maxdim, overlap=0.5)
        ref = jsa.select_pairs_of_crops((96, 128), (96, 128), xy1, xy2,
                                        maxdim=maxdim, overlap=0.5)
        assert len(got) == len(ref) >= 1
        for (a1, a2), (b1, b2) in zip(got, ref):
            np.testing.assert_array_equal(a1, b1)
            np.testing.assert_array_equal(a2, b2)


def test_mst_topo_order_matches_jax():
    edges = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (0, 3)]
    strengths = [100, 100, 80, 80, 60, 60, 1]
    for n, e, s in ((4, edges, strengths), (3, [(0, 1), (1, 0)], [5, 5]),
                    (5, make_pair_indices(5), list(range(20)))):
        for a, b in zip(sa.mst_topo_order(n, e, s),
                        jsa.mst_topo_order(n, e, s)):
            np.testing.assert_array_equal(a, b)


def test_refine_matches_coarse_to_fine_matches_jax():
    """tests/test_aligner.py's crop case: both packages' refinement with
    the same per-crop descriptor maps give equal matches."""
    h, w = 96, 128
    shift = np.array([6.0, 3.0])

    def desc_map(origin, shape, img_shift):
        gy, gx = np.mgrid[0:shape[0], 0:shape[1]].astype(np.float64)
        wp = (np.stack([gx + origin[0], gy + origin[1]], -1)
              - img_shift) * 0.1
        f = np.stack([wp[..., 0], wp[..., 1], np.sin(0.7 * wp[..., 0]),
                      np.cos(0.5 * wp[..., 1]), np.ones(shape)], -1)
        return (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(
            np.float32)

    img = np.zeros((h, w, 3))
    gy, gx = np.mgrid[8:h - 8:12, 8:w - 16:12]
    xy1 = np.stack([gx.ravel(), gy.ravel()], -1).astype(float)
    xy2 = xy1 + shift
    crops = jsa.select_pairs_of_crops((h, w), (h, w), xy1, xy2, maxdim=48,
                                      overlap=0.5)
    descs = [(desc_map(c1[:2], (c1[3] - c1[1], c1[2] - c1[0]), np.zeros(2)),
              desc_map(c2[:2], (c2[3] - c2[1], c2[2] - c2[0]), shift))
             for c1, c2 in crops]

    def infer(calls):
        def fn(c1, c2):
            calls.append((c1.shape, c2.shape))
            return descs[len(calls) - 1]
        return fn

    cj, ct = [], []
    ref = jsa.refine_matches_coarse_to_fine(img, img, xy1, xy2, infer(cj),
                                            maxdim=48, overlap=0.5,
                                            subsample=2)
    got = sa.refine_matches_coarse_to_fine(img, img, xy1, xy2, infer(ct),
                                           maxdim=48, overlap=0.5,
                                           subsample=2, device="cpu")
    assert ct == cj and len(ref[0]) > len(xy1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[1] - got[0],
                               np.tile(shift, (len(got[0]), 1)), atol=1.5)


def _chain_matches(preds):
    """The scene's matches with edge 0-2 thinned to 20, so that the MST
    is the chain 0 - 1 - 2 (the full matches give the star about 0)."""
    out = sa.extract_matches(preds, subsample=4, device="cpu")
    for e, (i, j) in enumerate(preds.edges):
        if {i, j} == {0, 2}:
            out[e] = (out[e][0][:20], out[e][1][:20])
    return out


CASES = {
    "default": {},
    "chain via view 1": {"chain": True},
    "free poses": {"kinematic_chain": False},
    "anchor depth": {"anchor3d_mode": "depth"},
    "anchor off": {"anchor3d_mode": "off"},
    "depths frozen": {"opt_depth": False},
    "wrong focal": {"focals": np.full(3, 24.0)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_global_alignment_matches_jax(case):
    kw = dict(CASES[case])
    c2w, _, jp, tp = _scenes()
    if kw.pop("chain", False):
        kw["matches"] = _chain_matches(tp)
        order, parent = sa.mst_topo_order(
            3, tp.edges, [len(m[0]) for m in kw["matches"]])
        assert list(parent) == [-1, 0, 1]
    ref = jsa.sparse_global_alignment(jp, subsample=4, niter1=30, niter2=30,
                                      **kw)
    got = sa.sparse_global_alignment(tp, subsample=4, niter1=30, niter2=30,
                                     device="cpu", **kw)
    np.testing.assert_allclose(got.c2w, ref.c2w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scales, ref.scales, rtol=1e-4)
    np.testing.assert_allclose(got.focals, ref.focals, rtol=1e-4)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-4)
    if ref.depth_scales is None:
        assert got.depth_scales is None
    else:
        assert got.depth_scales.shape == ref.depth_scales.shape
        np.testing.assert_allclose(got.depth_scales, ref.depth_scales,
                                   rtol=0, atol=1e-4)
    assert got.c2w.dtype == np.float64 and np.isfinite(got.loss)


def _eager_phase(p, loss_fn, trainable, niter, lr, lr_min, lr_fac, device,
                 name):
    """sparse_align's Adam phase as the port ran it before its StepLoop:
    host float32 scalars read every iteration, every leaf differentiated,
    the frozen ones' gradients zeroed, each leaf re-bound each step."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    m = {k: torch.zeros_like(x) for k, x in p.items()}
    vv = {k: torch.zeros_like(x) for k, x in p.items()}
    names = list(p)
    for it in range(niter):
        tt = f32(float(it))
        cur = f32(lr_min) + f32(lr - lr_min) * (
            1 + torch.cos(f32(np.pi) * tt / niter)) / 2
        bc1 = (1 - f32(0.9) ** (tt + 1)).item()
        leaves = [p[k].requires_grad_(True) for k in names]
        grads = torch.autograd.grad(loss_fn(p), leaves, allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None or k not in trainable:
                    g = torch.zeros_like(p[k])
                m[k] = 0.9 * m[k] + 0.1 * g
                vv[k] = 0.9 * vv[k] + 0.1 * g * g
                step = (f32(lr_fac[k]) * cur).item()
                p[k] = (p[k].detach() - step * (m[k] / bc1)
                        / (torch.sqrt(vv[k] / bc1) + 1e-8))
    with torch.no_grad():
        return loss_fn(p)


@pytest.mark.parametrize("case", ["default", "free poses", "depths frozen"])
def test_step_loop_phases_are_bit_equal_to_eager(case, monkeypatch):
    """Both phases as StepLoops (device tables, in-place updates, frozen
    leaves left out) give the eager loop's bits, 30 + 30 iterations."""
    _, _, _, tp = _scenes()
    kw = dict(CASES[case], subsample=4, niter1=30, niter2=30, device="cpu")
    got = sa.sparse_global_alignment(tp, **kw)
    monkeypatch.setattr(sa, "_adam_phase", _eager_phase)
    want = sa.sparse_global_alignment(tp, **kw)
    for field in ("c2w", "scales", "focals", "loss", "depth_scales"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_recovers_poses():
    """tests/test_aligner.py::test_sparse_global_alignment's gates."""
    c2w_gt, focal, _, tp = _scenes()
    res = sa.sparse_global_alignment(tp, subsample=4, niter1=300,
                                     niter2=150, device="cpu")
    assert np.isfinite(res.loss)
    rot, t = relative_pose_error(res.c2w, c2w_gt)
    assert rot < 0.05, rot
    assert t < 0.15, t
    np.testing.assert_allclose(res.scales, 1.0, atol=0.2)
    np.testing.assert_allclose(res.focals, focal, rtol=0.15)
    # free poses (test_sparse_alignment_free_poses_still_works)
    res = sa.sparse_global_alignment(tp, subsample=4, niter1=300, niter2=0,
                                     kinematic_chain=False, device="cpu")
    rot, t = relative_pose_error(res.c2w, c2w_gt)
    assert rot < 0.05 and t < 0.15, (rot, t)


def test_fine_phase_recovers_focal():
    """tests/test_aligner.py::test_sparse_fine_phase_recovers_focal."""
    _, focal, _, tp = _scenes()
    bad_f = 0.6 * focal
    res0 = sa.sparse_global_alignment(tp, subsample=4, niter1=300, niter2=0,
                                      focals=np.full(3, bad_f), device="cpu")
    res1 = sa.sparse_global_alignment(tp, subsample=4, niter1=300,
                                      niter2=300, focals=np.full(3, bad_f),
                                      device="cpu")
    np.testing.assert_allclose(res0.focals, bad_f, rtol=1e-6)
    err0 = abs(bad_f - focal) / focal
    err1 = np.abs(res1.focals - focal).max() / focal
    assert err1 < 0.5 * err0, (res1.focals, focal)


def test_depth_opt_recovers_noisy_depths():
    """tests/test_aligner.py::test_sparse_depth_opt_recovers_noisy_depths:
    ray-consistent per-pixel depth noise, exact matches."""
    n_views, h, w, focal, noise, ss = 3, 24, 32, 40.0, 0.05, 4
    c2w_gt, _, _ = sparse_scene(al.PairPrediction, n_views=n_views)
    rng = np.random.default_rng(0)
    D = 1.0 + noise * rng.standard_normal((n_views, h, w))
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    pts_cam_n, pts_world_n, pts_world_c = [], [], []
    for v in range(n_views):
        Rv, tv = c2w_gt[v, :3, :3], c2w_gt[v, :3, 3]
        dirs = np.stack([(gx - w / 2) / focal, (gy - h / 2) / focal,
                         np.ones_like(gx)], -1)
        d_world = dirs @ Rv.T
        lam = (3.0 - tv[2]) / d_world[..., 2]
        pw = tv + lam[..., None] * d_world
        pc = (pw - tv) @ Rv
        pts_world_c.append(pw)
        pcn = pc * D[v][..., None]
        pts_cam_n.append(pcn)
        pts_world_n.append(tv + pcn @ Rv.T)
    edges = make_pair_indices(n_views, "complete", symmetrize=True)
    pred_i = np.stack([pts_cam_n[i] for i, j in edges]).astype(np.float32)
    pred_j = np.stack([
        (pts_world_n[j] - c2w_gt[i, :3, 3]) @ c2w_gt[i, :3, :3]
        for i, j in edges]).astype(np.float32)
    conf = 1.0 + np.exp(rng.random((len(edges), h, w)).astype(np.float32))
    preds = al.PairPrediction(edges=edges, pred_i=pred_i, pred_j=pred_j,
                              conf_i=conf, conf_j=conf * 1.1)

    def desc_of(v):
        wd = pts_world_c[v]
        x, y = wd[..., 0], wd[..., 1]
        f = np.stack([x, y, np.sin(0.5 * x), np.cos(0.4 * y),
                      np.sin(0.3 * (x + y)), np.ones_like(x)], -1)
        return (f / np.linalg.norm(f, axis=-1, keepdims=True)).astype(
            np.float32)

    preds.desc_i = np.stack([desc_of(i) for i, j in edges])
    preds.desc_j = np.stack([desc_of(j) for i, j in edges])
    res_off = sa.sparse_global_alignment(preds, subsample=ss, niter1=300,
                                         niter2=300, opt_depth=False,
                                         device="cpu")
    res_on = sa.sparse_global_alignment(preds, subsample=ss, niter1=300,
                                        niter2=300, opt_depth=True,
                                        device="cpu")
    assert res_off.depth_scales is None
    assert res_on.loss < res_off.loss
    rot_off, _ = relative_pose_error(res_off.c2w, c2w_gt)
    rot_on, _ = relative_pose_error(res_on.c2w, c2w_gt)
    assert rot_on < rot_off
    tgt = -np.log(D[:, ss // 2::ss, ss // 2::ss])
    got = res_on.depth_scales[:, :tgt.shape[1], :tgt.shape[2]]
    corr = np.corrcoef(got.ravel(), tgt.ravel())[0, 1]
    assert corr > 0.35, corr
    assert 0.5 < got.std() / tgt.std() < 2.0
