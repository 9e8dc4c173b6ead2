"""Sparse (correspondence-based) global alignment (port of
instantsplat_tpu/init/sparse_align.py, MASt3R's sparse_ga.py).

1. reciprocal descriptor matching per directed edge (ops/matching.py) on a
   subsampled anchor grid, optionally refined coarse-to-fine on crop pairs
   (`refine_matches_coarse_to_fine`);
2. each match ties the two images' sim3s together; an edge whose matching
   is too weak falls back to a grid-anchor regression term weighted
   `loss_dust3r_w`;
3. two Adam phases: COARSE (3D point coincidence, poses and scales only)
   and FINE (2D reprojection, plus log-focals, principal points and, with
   `opt_depth`, per-anchor-cell log depth scales).

The host half (matching glue, crop selection, the MST) is the JAX
package's numpy, copied with every tie-break. The two phases are PyTorch
loops on `device` (on a card replays of one captured CUDA graph of the
step, utils/cuda_graphs.StepLoop, as JAX jits each phase's fori_loop)
with JAX's exact Adam: betas 0.9/0.9, eps 1e-8, the bias
correction 1 - 0.9^(t+1) in float32 for both moments, the cosine schedule
lr_min + (lr - lr_min)(1 + cos(pi t / n)) / 2, the factor
`depth_lr_scale` on the depth leaf's update; a leaf a phase freezes
keeps its value (JAX zeroes its gradient: its moments stay 0 and its
update is exactly 0). Poses are a kinematic
chain over the match-strength MST (`kinematic_chain`), composed in the
host's static traversal order. `jnp.clip` and `jnp.maximum` split the
gradient at a tie and `torch.clamp` does not, so the clamps are
`torch.maximum` / `torch.minimum` with tensor bounds. The JAX module's
docstring records the measurements behind `anchor3d_mode`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.init import geometry as G
from instantsplat_tpu_torch.ops.matching import fast_reciprocal_nns
from instantsplat_tpu_torch.utils import transforms as T
from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop, StepTable


def extract_matches(preds, subsample=8, device="cuda"):
    """Match descriptors for each directed edge of a PairPrediction that
    carries desc_i/desc_j (models/mast3r_infer attaches them), on `device`.

    Returns per-edge (xy1 [M,2], xy2 [M,2]) pixel coordinate arrays.
    """
    assert hasattr(preds, "desc_i"), "PairPrediction lacks descriptors"
    out = []
    for e in range(len(preds.edges)):
        xy1, xy2 = fast_reciprocal_nns(
            preds.desc_i[e], preds.desc_j[e], subsample=subsample,
            device=device)
        out.append((xy1, xy2))
    return out


# -- coarse-to-fine crop refinement (mast3r/utils/coarse_to_fine.py) -------

def _multiple_of_16(x):
    return max((int(x) // 16) * 16, 16)


def _start_positions(total, win, overlap):
    """First window at 0, last at total-win, spacing <= win*(1-overlap)
    (coarse_to_fine.py:18-26)."""
    if total <= win:
        return np.zeros(1, int)
    spacing = win * (1 - overlap)
    last = total - win
    n = 2 + int((last - 1) // spacing)
    return np.linspace(0, last, n).round().astype(int)


def _overlapping_grid(h, w, maxdim, overlap):
    """[K, 4] crop cells (x0, y0, x1, y1) tiling the image with windows of
    long side `maxdim` (aspect preserved, /16 sizes;
    coarse_to_fine.py:33-40)."""
    scale = maxdim / max(h, w)
    hw = _multiple_of_16(min(h, int(h * scale)))
    ww = _multiple_of_16(min(w, int(w * scale)))
    xs = _start_positions(w, ww, overlap)
    ys = _start_positions(h, hw, overlap)
    gx, gy = np.meshgrid(xs, ys)
    cells = np.stack([gx, gy, gx + ww, gy + hw], -1).reshape(-1, 4)
    return cells


def _center_weight(cells, pts, assigned, gauss_var=2.0):
    """Gaussian down-weighting of matches far from the crop center
    (coarse_to_fine.py:91-101)."""
    center = (cells[:, :2] + cells[:, 2:]) / 2.0
    size = np.maximum(cells[:, 2:] - cells[:, :2], 1.0)
    rel = (pts[None] - center[:, None]) / (size[:, None] / 2.0)
    w = np.exp(-np.sum(rel**2, -1) / (2 * gauss_var))
    return np.where(assigned, w, 0.0)


def select_pairs_of_crops(shape1, shape2, xy1, xy2, maxdim=512,
                          overlap=0.5, min_corres=10, target=0.9):
    """-> list of (cell1 [4], cell2 [4]) int crop rectangles (x0,y0,x1,y1).

    Clean-room equivalent of coarse_to_fine.py:184-215
    `select_pairs_of_crops`: grid the query image into overlapping /16
    windows, estimate each window's corresponding rectangle in the other
    image from the assigned matches' center and 10-90% spread, score by
    center-weighted coverage, run both directions, and greedily pick crop
    pairs until `target` of the total coverable match weight is covered.
    """
    xy1 = np.asarray(xy1, np.float64)
    xy2 = np.asarray(xy2, np.float64)
    if len(xy1) < min_corres:
        return []

    def one_direction(shape_q, shape_b, pq, pb):
        cells_q = _overlapping_grid(*shape_q, maxdim, overlap)
        inside = ((pq[None, :, 0] >= cells_q[:, None, 0])
                  & (pq[None, :, 0] < cells_q[:, None, 2])
                  & (pq[None, :, 1] >= cells_q[:, None, 1])
                  & (pq[None, :, 1] < cells_q[:, None, 3]))
        keep = inside.sum(1) >= min_corres
        cells_q, inside = cells_q[keep], inside[keep]
        if not len(cells_q):
            return (np.zeros((0, 4)), np.zeros((0, 4)),
                    np.zeros((0, len(pq))))
        pb_m = np.where(inside[:, :, None], pb[None], np.nan)
        pq_m = np.where(inside[:, :, None], pq[None], np.nan)
        center_b = np.nanmean(pb_m, axis=1)
        q10_q, q90_q = np.nanquantile(pq_m, (0.1, 0.9), axis=1)
        q10_b, q90_b = np.nanquantile(pb_m, (0.1, 0.9), axis=1)
        std_q = np.clip(q90_q - q10_q, 20.0, None)
        std_b = np.clip(q90_b - q10_b, 20.0, None)
        size_b = (cells_q[:, 2:] - cells_q[:, :2]) * std_b / std_q
        cells_b = np.concatenate(
            [center_b - size_b / 2, center_b + size_b / 2], -1)
        # clip to image, keep /16-friendly bounds
        hb, wb = shape_b
        cells_b[:, 0::2] = np.clip(cells_b[:, 0::2], 0, wb)
        cells_b[:, 1::2] = np.clip(cells_b[:, 1::2], 0, hb)
        weights = (_center_weight(cells_q, pq, inside)
                   * _center_weight(cells_b, pb, inside))
        return cells_q, cells_b, weights

    c1a, c2a, wa = one_direction(shape1, shape2, xy1, xy2)
    c2b, c1b, wb = one_direction(shape2, shape1, xy2, xy1)
    cell1 = np.concatenate([c1a, c1b])
    cell2 = np.concatenate([c2a, c2b])
    weights = np.concatenate([wa, wb])
    if not len(weights):
        return []

    # greedy set cover to `target` coverage (coarse_to_fine.py:156-182)
    w = weights.copy()
    total = w.max(0).sum()
    goal = target * total
    covered = np.zeros(w.shape[1])
    order = []
    while covered.sum() < goal and len(order) < len(w):
        best = int(w.sum(1).argmax())
        if w[best].sum() <= 0:
            break
        order.append(best)
        covered += w[best]
        w = np.clip(w - w[best], 0, None)
    return [(cell1[i].astype(int), cell2[i].astype(int)) for i in order]


def refine_matches_coarse_to_fine(
    img1, img2, xy1, xy2,
    infer_fn: Callable,
    maxdim=512, overlap=0.5, subsample=4, min_corres=10, device="cuda",
):
    """Coarse matches -> finer matches via crop-pair re-inference.

    The reference re-runs the network on selected crop pairs at native
    resolution and re-matches (mast3r fine-matching pipeline around
    coarse_to_fine.select_pairs_of_crops). `infer_fn(crop1, crop2)` must
    return (desc1 [h,w,D], desc2 [h,w,D]) descriptor maps for the two
    crops (any internal resolution; coordinates are rescaled back). The
    crops' matching runs on `device`.

    Returns (xy1_fine [M,2], xy2_fine [M,2]) in FULL-image pixel coords;
    falls back to the coarse matches when no crop pair qualifies.
    """
    crops = select_pairs_of_crops(
        np.asarray(img1).shape[:2], np.asarray(img2).shape[:2],
        xy1, xy2, maxdim=maxdim, overlap=overlap, min_corres=min_corres)
    if not crops:
        return np.asarray(xy1), np.asarray(xy2)
    out1, out2 = [], []
    for cell1, cell2 in crops:
        x0a, y0a, x1a, y1a = cell1
        x0b, y0b, x1b, y1b = cell2
        if x1a - x0a < 16 or y1a - y0a < 16 \
                or x1b - x0b < 16 or y1b - y0b < 16:
            continue
        c1 = np.asarray(img1)[y0a:y1a, x0a:x1a]
        c2 = np.asarray(img2)[y0b:y1b, x0b:x1b]
        d1, d2 = infer_fn(c1, c2)
        m1, m2 = fast_reciprocal_nns(d1, d2, subsample=subsample,
                                     device=device)
        if not len(m1):
            continue
        s1 = np.array([c1.shape[1] / d1.shape[1],
                       c1.shape[0] / d1.shape[0]])
        s2 = np.array([c2.shape[1] / d2.shape[1],
                       c2.shape[0] / d2.shape[0]])
        out1.append(m1 * s1 + [x0a, y0a])
        out2.append(m2 * s2 + [x0b, y0b])
    if not out1:
        return np.asarray(xy1), np.asarray(xy2)
    f1 = np.concatenate(out1)
    f2 = np.concatenate(out2)
    # overlapping crops produce duplicates: dedup on rounded query coords
    _, idx = np.unique(f1.round().astype(int), axis=0, return_index=True)
    return f1[np.sort(idx)], f2[np.sort(idx)]


# -- two-phase sparse optimizer (sparse_ga.py:158-463) ---------------------


def mst_topo_order(n_imgs, edges, strengths):
    """Maximum-strength spanning tree rooted at image 0, as a traversal.

    -> (order [V] int, parent [V] int; parent[order[0]] = -1). The
    reference builds its kinematic chain from the MST of pairwise match
    confidence (sparse_ga.py:205-211 `compute_min_spanning_tree` over
    `-msp` scores); strengths here are per-directed-edge (higher =
    better), merged to undirected max.
    """
    import scipy.sparse as sp

    g = sp.dok_array((n_imgs, n_imgs))
    for (i, j), s in zip(edges, strengths):
        a, b = (i, j) if i < j else (j, i)
        g[a, b] = min(g[a, b], -float(s)) if g[a, b] else -float(s)
    msp = sp.csgraph.minimum_spanning_tree(g.tocsr()).tocoo()
    adj = [[] for _ in range(n_imgs)]
    for a, b in zip(msp.row, msp.col):
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    parent = np.full(n_imgs, -1, int)
    order, seen = [0], {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for w in adj[u]:
            if w not in seen:
                seen.add(w)
                parent[w] = u
                order.append(w)
                stack.append(w)
    # disconnected images (no edges at all) chain to the root
    for k in range(n_imgs):
        if k not in seen:
            parent[k] = 0
            order.append(k)
    return np.asarray(order, int), parent


class SparseGAResult(NamedTuple):
    c2w: np.ndarray  # [V, 4, 4]
    scales: np.ndarray  # [V]
    focals: np.ndarray  # [V]
    loss: float
    # fine-phase per-anchor-cell log depth scales [V, ceil(H/ss), ceil(W/ss)]
    # (0 = predicted depth); None when opt_depth=False
    depth_scales: Optional[np.ndarray] = None


def _gamma_np(gamma):
    """Reference gamma_loss (mast3r/cloud_opt/utils/losses.py:19-28):
    (d + offset)^gamma - offset^gamma with unit slope at d=0."""
    if gamma == 1.0:
        return lambda d: d
    offset = (1.0 / gamma) ** (1.0 / (gamma - 1.0))

    def f(d):
        return (d + offset) ** gamma - offset ** gamma

    return f


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def sparse_global_alignment(
    preds,
    matches=None,
    subsample=8,
    niter1=300, lr1=0.07,
    niter2=300, lr2=0.014,
    lr_min=1e-6,
    gamma1=1.1, gamma2=0.4,
    matching_conf_thr=0.0, min_matches=8, loss_dust3r_w=0.01,
    anchor3d_w=10.0,
    focals: Optional[np.ndarray] = None,
    kinematic_chain=True,
    opt_depth=True,
    depth_reg_w=1.0,
    depth_lr_scale=0.3,
    anchor3d_mode="pred",
    seed=0,
    device="cuda",
):
    """-> SparseGAResult(c2w [V,4,4], scales [V], focals [V], loss,
    depth_scales), numpy float64.

    preds: PairPrediction with descriptors (or `matches`, per-edge
    (xy1, xy2)); view 0 anchors the gauge. `focals` overrides the
    per-image Weiszfeld init; `kinematic_chain` parameterises poses relative
    to the match-MST parent, False = free per-image poses; `opt_depth`
    optimises per-anchor-cell log depth scales in the fine phase;
    `anchor3d_mode` is the fine phase's 3D term: "pred" on the predicted
    depths, "depth" on the optimised ones, "off" none (the reference's
    reprojection-only fine loss). Matching (when `matches` is None) and
    both phases run on `device`.
    """
    dev = resolve_device(device)
    if matches is None:
        matches = extract_matches(preds, subsample=subsample, device=dev)
    v = preds.n_imgs
    h, w = preds.imshape
    diag = float(np.hypot(h, w))

    # own-frame pointmaps per image (from its directed edges)
    own, conf_own = {}, {}
    for e, (i, j) in enumerate(preds.edges):
        if i not in own:
            own[i] = np.asarray(preds.pred_i[e])
            conf_own[i] = np.asarray(preds.conf_i[e])

    # constraint list over strong (matched) edges + weak-edge fallbacks
    ai, aj, pi, pj, x1, x2, wgt, strong = ([] for _ in range(8))
    gy, gx = np.mgrid[subsample // 2:h:subsample,
                      subsample // 2:w:subsample]
    grid = np.stack([gx.ravel(), gy.ravel()], -1)
    for e, (i, j) in enumerate(preds.edges):
        xy1, xy2 = matches[e]
        c = None
        if len(xy1) >= min_matches:
            c = np.minimum(conf_own[i][xy1[:, 1], xy1[:, 0]],
                           conf_own[j][xy2[:, 1], xy2[:, 0]])
        if c is not None and float(c.max()) > matching_conf_thr:
            ai.append(np.full(len(xy1), i))
            aj.append(np.full(len(xy1), j))
            pi.append(own[i][xy1[:, 1], xy1[:, 0]])
            pj.append(own[j][xy2[:, 1], xy2[:, 0]])
            x1.append(np.asarray(xy1, np.float32))
            x2.append(np.asarray(xy2, np.float32))
            wgt.append(np.log(np.clip(c, 1e-8, None)))
            strong.append(np.ones(len(xy1), bool))
        else:
            # regression fallback on the anchor grid (sparse_ga.py:307-315):
            # j's points seen in i's frame vs j's own points
            ai.append(np.full(len(grid), i))
            aj.append(np.full(len(grid), j))
            pi.append(np.asarray(preds.pred_j[e])[grid[:, 1], grid[:, 0]])
            pj.append(own[j][grid[:, 1], grid[:, 0]])
            x1.append(np.asarray(grid, np.float32))
            x2.append(np.asarray(grid, np.float32))
            cw = np.asarray(preds.conf_j[e])[grid[:, 1], grid[:, 0]]
            wgt.append(np.log(np.clip(cw, 1e-8, None)))
            strong.append(np.zeros(len(grid), bool))
    ai_np = np.concatenate(ai)
    aj_np = np.concatenate(aj)
    x1_np = np.concatenate(x1)
    x2_np = np.concatenate(x2)
    # scene-scale normaliser of the 3D terms
    scene_norm = float(np.median(np.linalg.norm(
        np.concatenate(pj), axis=1))) or 1.0

    def dt(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    ai = dt(ai_np, torch.long)
    aj = dt(aj_np, torch.long)
    pi = dt(np.concatenate(pi))
    pj = dt(np.concatenate(pj))
    x1 = dt(x1_np)
    x2 = dt(x2_np)
    wgt = dt(np.concatenate(wgt))
    strong_f = dt(np.concatenate(strong))
    w_strong = wgt * strong_f
    w_weak = wgt * (1 - strong_f)
    floor = torch.tensor(1e-8, device=dev)
    n_strong = torch.maximum(torch.sum(w_strong), floor)
    n_weak = torch.maximum(torch.sum(w_weak), floor)

    # per-anchor-cell depth-scale slots: constraint row -> (image, cell);
    # the i-side of a weak row is a cross-frame prediction, gated off by
    # `strong_f` inside world_points
    wa = -(-w // subsample)
    n_cells = wa * (-(-h // subsample))

    def _slots(img_arr, xy_arr):
        cy = xy_arr[:, 1].astype(np.int64) // subsample
        cx = xy_arr[:, 0].astype(np.int64) // subsample
        return img_arr.astype(np.int64) * n_cells + cy * wa + cx

    slot_i = dt(_slots(ai_np, x1_np), torch.long)
    slot_j = dt(_slots(aj_np, x2_np), torch.long)

    # per-image focal init (Weiszfeld on the own-frame pointmap), pp at the
    # image centre
    if focals is None:
        f0 = np.empty(v)
        got = {i: G.estimate_focal_weiszfeld(own[i]) for i in sorted(own)}
        mean_f = (float(np.mean(list(got.values())))
                  if got else 0.8 * max(h, w))
        for i in range(v):
            f0[i] = got.get(i, mean_f)
    else:
        f0 = np.broadcast_to(np.asarray(focals, np.float64), (v,)).copy()

    rng = np.random.default_rng(seed)
    params = dict(
        pose=dt(np.tile([1, 0, 0, 0, 0, 0, 0, 0], (v, 1))
                + rng.standard_normal((v, 8)) * 0.01),
        log_focal=dt(np.log(f0)),
        pp=dt(np.tile([w / 2.0, h / 2.0], (v, 1))),
        log_dscale=torch.zeros(v * n_cells, device=dev),
    )

    # kinematic chain over the match-strength MST (sparse_ga.py:254-260)
    chain = []
    if kinematic_chain and v > 1:
        strengths = [
            float(len(matches[e][0]))
            if len(matches[e][0]) >= min_matches else 0.5
            for e in range(len(preds.edges))
        ]
        order_np, parent_np = mst_topo_order(v, preds.edges, strengths)
        assert int(order_np[0]) == 0  # root = gauge anchor
        chain = [(int(k), int(parent_np[k])) for k in order_np[1:]]

    g1 = _gamma_np(gamma1)
    g2 = _gamma_np(gamma2)
    gd = _gamma_np(1.1)  # lossd = gamma_loss(1.1), sparse_ga.py:162
    gauge = (torch.arange(v, device=dev) > 0).float()[:, None]
    ident = torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.float32,
                         device=dev)[None]
    f_lo = torch.tensor(0.25 * diag, device=dev)  # sparse_ga.py:226-228
    f_hi = torch.tensor(10.0 * diag, device=dev)
    z_floor = torch.tensor(1e-6, device=dev)
    f0_ref = dt(f0)

    def decode(p):
        wp = p["pose"] * gauge + ident * (1 - gauge)
        R = T.quat_to_rotmat(T.quat_normalize(wp[:, :4]))
        t = G.signed_expm1(wp[:, 4:7])
        if chain:
            # absolute poses down the tree, in the static traversal order;
            # root 0's relative pose is the masked identity
            Rl, tl = list(R.unbind(0)), list(t.unbind(0))
            for k, par in chain:
                Rl[k] = Rl[par] @ R[k]
                tl[k] = Rl[par] @ t[k] + tl[par]
            R = torch.stack(Rl)
            t = torch.stack(tl)
        s = torch.exp(wp[:, 7])
        f = torch.minimum(torch.maximum(torch.exp(p["log_focal"]), f_lo),
                          f_hi)
        return R, t, s, f, p["pp"]

    def world_points(R, t, s, dsc, f=None):
        # moving a camera-frame point along its pixel ray == scaling it;
        # with `f`, depths also ride the current/initial focal ratio
        di = dsc[slot_i] * strong_f
        dj = dsc[slot_j]
        if f is not None:
            fr = torch.log(f / f0_ref)
            di = di + fr[ai] * strong_f
            dj = dj + fr[aj]
        pi_eff = pi * torch.exp(di)[:, None]
        pj_eff = pj * torch.exp(dj)[:, None]
        w1 = (torch.einsum("nij,nj->ni", R[ai], pi_eff) * s[ai][:, None]
              + t[ai])
        w2 = (torch.einsum("nij,nj->ni", R[aj], pj_eff) * s[aj][:, None]
              + t[aj])
        return w1, w2

    def dist3(w1, w2):
        return torch.sqrt(torch.sum((w1 - w2) ** 2, -1) + 1e-12) / scene_norm

    def loss_weak(w1, w2):
        return torch.sum(gd(dist3(w1, w2)) * w_weak) / n_weak

    def loss_coarse(p):
        R, t, s, _, _ = decode(p)
        w1, w2 = world_points(R, t, s, p["log_dscale"])
        l3d = torch.sum(g1(dist3(w1, w2)) * w_strong) / n_strong
        return l3d + loss_dust3r_w * loss_weak(w1, w2)

    def reproj(Rk, tk, sk, fk, ppk, world):
        cam = torch.einsum("nji,nj->ni", Rk, world - tk) / sk[:, None]
        z = torch.maximum(cam[:, 2], z_floor)
        return fk[:, None] * cam[:, :2] / z[:, None] + ppk

    def loss_fine(p):
        R, t, s, f, pp = decode(p)
        # depth freedom in the reprojection term only; the 3D anchor stays
        # on the predicted depths unless anchor3d_mode == "depth"
        w1d, w2d = world_points(R, t, s, p["log_dscale"], f=f)
        w1, w2 = world_points(R, t, s, torch.zeros_like(p["log_dscale"]))
        if anchor3d_mode == "depth":
            w1, w2 = w1d, w2d
        u1 = reproj(R[ai], t[ai], s[ai], f[ai], pp[ai], w2d)
        u2 = reproj(R[aj], t[aj], s[aj], f[aj], pp[aj], w1d)
        d1 = torch.sqrt(torch.sum((u1 - x1) ** 2, -1) + 1e-12)
        d2 = torch.sqrt(torch.sum((u2 - x2) ** 2, -1) + 1e-12)
        loss = torch.sum((g2(d1) + g2(d2)) * w_strong) / (2 * n_strong)
        if anchor3d_mode != "off":
            l3d = torch.sum(g1(dist3(w1, w2)) * w_strong) / n_strong
            loss = loss + anchor3d_w * l3d
        # depth-scale prior toward the predictions
        dsc = p["log_dscale"]
        reg = torch.mean(dsc[slot_j] ** 2 + strong_f * dsc[slot_i] ** 2)
        return loss + loss_dust3r_w * loss_weak(w1, w2) + depth_reg_w * reg

    # Adam normalises gradient magnitude, so the gentler depth step scales
    # the UPDATE (a per-leaf lr factor)
    lr_fac = dict(pose=1.0, log_focal=1.0, pp=1.0, log_dscale=depth_lr_scale)

    final = None
    if niter1:  # coarse: poses and scales only (sparse_ga.py:432-439)
        final = _adam_phase(params, loss_coarse, ("pose",), niter1, lr1,
                            lr_min, lr_fac, dev, "sparse_align coarse")
    if niter2:  # core_depth trains only here (sparse_ga.py:440-453)
        trainable = ("pose", "log_focal", "pp") + (
            ("log_dscale",) if opt_depth else ())
        final = _adam_phase(params, loss_fine, trainable, niter2, lr2,
                            lr_min, lr_fac, dev, "sparse_align fine")

    with torch.no_grad():
        R_abs, t_abs, s_abs, f_abs, _ = decode(params)
    R_np = R_abs.cpu().numpy().astype(np.float64)
    t_np = t_abs.cpu().numpy().astype(np.float64)
    scales = s_abs.cpu().numpy().astype(np.float64)
    focals_out = f_abs.cpu().numpy().astype(np.float64)
    c2w = np.tile(np.eye(4), (v, 1, 1))
    c2w[:, :3, :3] = R_np
    c2w[:, :3, 3] = t_np
    c2w[0] = np.eye(4)  # gauge anchor
    dsc_out = None
    if opt_depth and niter2:
        dsc_out = params["log_dscale"].cpu().numpy().astype(
            np.float64).reshape(v, n_cells // wa, wa)
    return SparseGAResult(c2w, scales, focals_out,
                          np.nan if final is None else float(final), dsc_out)


def _phase_rows(niter: int, lr: float, lr_min: float, facs) -> torch.Tensor:
    """[niter, 1 + len(facs)] float32: each iteration's bias correction
    1 - 0.9^(t+1) and each leaf's step size fac * (the cosine rate), as
    JAX's traced loop computes them in float32 (0-dim float32 ops)."""
    rows = []
    for it in range(niter):
        tt = _f32(float(it))
        cur = _f32(lr_min) + _f32(lr - lr_min) * (
            1 + torch.cos(_f32(math.pi) * tt / niter)) / 2
        bc1 = 1 - _f32(0.9) ** (tt + 1)
        rows.append(torch.stack([bc1] + [_f32(f) * cur for f in facs]))
    return torch.stack(rows)


def _adam_phase(p: dict, loss_fn, trainable, niter: int, lr: float,
                lr_min: float, lr_fac: dict, device, name: str):
    """One Adam phase over the leaves `trainable` of `p` (JAX's jitted
    fori_loop): the parameters and moments are updated in place, the rate
    and the bias correction come from a device table by a device step
    counter, so on a card the step is one captured CUDA graph replayed
    `niter` times (utils/cuda_graphs.StepLoop). A leaf the phase freezes
    takes no step: with JAX's zeroed gradient its moments stay 0 and its
    update is exactly 0. -> the phase's final loss, a 0-dim device tensor
    (read by the caller once)."""
    names = [k for k in p if k in trainable]
    m = {k: torch.zeros_like(p[k]) for k in names}
    v = {k: torch.zeros_like(p[k]) for k in names}
    table = StepTable(_phase_rows(niter, lr, lr_min,
                                  [lr_fac[k] for k in names]), device)
    leaves = [p[k].requires_grad_(True) for k in names]

    def step():
        row = table.row()
        grads = torch.autograd.grad(loss_fn(p), leaves, allow_unused=True)
        with torch.no_grad():
            bc1 = row[0]
            for j, (k, g) in enumerate(zip(names, grads)):
                if g is None:
                    g = torch.zeros_like(p[k])
                m[k].mul_(0.9).add_(0.1 * g)
                v[k].mul_(0.9).add_(0.1 * g * g)
                p[k].sub_(row[1 + j] * (m[k] / bc1)
                          / (torch.sqrt(v[k] / bc1) + 1e-8))
            table.advance()

    StepLoop(step, device, name).run(niter)
    for x in leaves:
        x.requires_grad_(False)
    with torch.no_grad():
        return loss_fn(p)
