"""Global alignment: fuse pairwise pointmaps into one scene + camera poses
(port of instantsplat_tpu/init/aligner.py).

The reference is dust3r's `PointCloudOptimizer` + `global_alignment_loop`
(dust3r/cloud_opt/optimizer.py, base_opt.py:288-366), the stage that turns
MASt3R's N*(N-1) pairwise pointmap predictions into a single metric point
cloud with per-image poses, depths and focals. Same parameterization and
loss as the JAX package:

- per-edge sim3 `pw_poses` [E, 8] = (quat, signed-log1p trans, log scale)
  with the product-of-scales normalized to base_scale (base_opt.py:180-192);
- per-image log-depthmaps [V, A], poses [V, 7] (quat + signed-log1p trans,
  cam-to-world), log-focals scaled by focal_break=20 (optimizer.py:29-33);
- loss = sum over directed edges of conf-weighted L1 between the scene
  points unprojected from (depth, focal, pose) and the edge's pointmap
  transformed by its sim3 (optimizer.py:188-201; conf transform = log,
  per-side normalization by total pixel area);
- init on the host: confidence-scored minimum spanning tree with chained
  sim3 registrations (init_im_poses.py:135-221), Weiszfeld focals,
  RANSAC-PnP completion of poses the walk leaves open (init/pnp.py), then
  per-edge registration onto the fused cloud (init_im_poses.py:92-133);
- optimization: Adam(betas=(0.9, 0.9), eps 1e-8) with a cosine (or
  linear) rate from lr to 1e-6, 300 iterations (base_opt.py:326-366),
  written out by hand as JAX's loop is, on the aligner's device.

The loop's step works on stacked [E, H*W] tensors and reads its rate and
bias corrections from a device table by a device step counter, so it
runs as JAX's fori_loop blocks do, on the device: on a card one step is
captured into a CUDA graph and replayed for the 300 iterations
(utils/cuda_graphs.StepLoop), on the CPU it runs in a Python loop; no
host read until the end. The JAX package's ~60 s block dispatch is a TPU
workaround, not ported. With a mesh, each rank holds a contiguous share
of the edges (when the rank
count divides E) or of the pixels (when it divides H*W), the parameters
replicated (rank 0's start broadcast); each rank's loss is its share of
the global sum, still divided by the global counts, and the gradients
are summed over the ranks before every identical Adam step. On the card
the backward of the per-edge gathers `world[ei]` adds with atomics, so
the card's result is tolerance-equal to the CPU's, not bit-equal. With a
mesh the captured step holds the gradient all-reduce (NCCL).
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import scipy.sparse as sp
import torch

from instantsplat_tpu_torch import resolve_device
from instantsplat_tpu_torch.init import geometry as G
from instantsplat_tpu_torch.init import pnp
from instantsplat_tpu_torch.utils import transforms as T
from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop, StepTable
from instantsplat_tpu_torch.utils.transforms import (qvec_to_rotmat,
                                                     rotmat_to_qvec)


@dataclasses.dataclass
class PairPrediction:
    """Stacked pairwise predictions for E directed edges over V images.

    pred_i[e] = image edges[e][0]'s pointmap in its own camera frame;
    pred_j[e] = image edges[e][1]'s pointmap in image edges[e][0]'s frame
    (the MASt3R head-2 output, dust3r/model.py:198-210).
    """

    edges: list[tuple[int, int]]
    pred_i: np.ndarray  # [E, H, W, 3]
    pred_j: np.ndarray  # [E, H, W, 3]
    conf_i: np.ndarray  # [E, H, W]
    conf_j: np.ndarray  # [E, H, W]
    # Mixed-aspect scenes (reference: dust3r/inference.py:62-64 runs them
    # at batch_size=1): maps live on one (Hmax, Wmax) canvas, each image's
    # true raster at the top-left; shapes[v] = its (h, w). Padded pixels
    # MUST carry conf == 1.0 — the aligner's log-conf loss weight is then
    # exactly 0 (genuine MASt3R confs are 1 + exp(x) > 1). None = uniform.
    shapes: np.ndarray | None = None

    @property
    def n_imgs(self):
        return max(max(e) for e in self.edges) + 1

    @property
    def imshape(self):
        return self.pred_i.shape[1:3]


def _pose7_to_c2w_np(p):
    q = np.asarray(p[:4], np.float64)
    q = q / np.linalg.norm(q)
    m = np.eye(4)
    m[:3, :3] = qvec_to_rotmat(q)
    m[:3, 3] = G.signed_expm1(np.asarray(p[4:7], np.float64))
    return m


def _rotate(pts, M):
    """pts [B, A, 3] @ M[B]^T ([B, 3, 3]) as three broadcast products. A
    batched matmul's backward reduces M's gradient over the A pixels in a
    gemm with a 3x3 output, which cuBLAS runs on a handful of CTAs (16 of
    an iteration's 20 ms on the H100 at 512x384); broadcasting's backward
    is a sum reduction over A instead."""
    Mt = M[:, None]
    return (pts[..., 0:1] * Mt[..., 0] + pts[..., 1:2] * Mt[..., 1]
            + pts[..., 2:3] * Mt[..., 2])


class GlobalAligner:
    """Build from PairPrediction, init with MST, optimize, extract scene."""

    def __init__(
        self,
        preds: PairPrediction,
        min_conf_thr: float = 3.0,
        base_scale: float = 0.5,
        pw_break: float = 20.0,
        focal_break: float = 20.0,
        seed: int = 0,
        device="cuda",
    ):
        self.preds = preds
        self.device = device
        self.edges = list(preds.edges)
        self.edge_index = {e: k for k, e in enumerate(self.edges)}
        self.n_imgs = preds.n_imgs
        self.H, self.W = preds.imshape
        self.area = self.H * self.W
        self.min_conf_thr = min_conf_thr
        self.base_scale = base_scale
        self.pw_break = pw_break
        self.focal_break = focal_break
        # per-image true rasters (mixed-aspect canvases; see PairPrediction)
        if preds.shapes is not None:
            self.shapes = np.asarray(preds.shapes, np.int64)
        else:
            self.shapes = np.tile([self.H, self.W], (self.n_imgs, 1))
        self.mixed = bool((self.shapes != [self.H, self.W]).any())

        # per-image confidence = max over all edge predictions touching it
        # (base_opt.py:128-141 _compute_img_conf)
        self.im_conf = np.zeros((self.n_imgs, self.H, self.W), np.float32)
        for e, (i, j) in enumerate(self.edges):
            self.im_conf[i] = np.maximum(self.im_conf[i], preds.conf_i[e])
            self.im_conf[j] = np.maximum(self.im_conf[j], preds.conf_j[e])

        rng = np.random.default_rng(seed)
        self.params = {
            "pw_poses": rng.standard_normal(
                (len(self.edges), 8)).astype(np.float32),
            "im_poses": rng.standard_normal(
                (self.n_imgs, 7)).astype(np.float32),
            "im_depth": (rng.standard_normal(
                (self.n_imgs, self.area)) / 10 - 3).astype(np.float32),
            "im_focals": (focal_break * np.log(
                self.shapes.max(axis=1, keepdims=True))).astype(np.float32),
        }
        # principal points at each image's TRUE raster center
        self.pp = np.stack([self.shapes[:, 1] / 2.0,
                            self.shapes[:, 0] / 2.0], -1).astype(np.float32)
        self.focals_frozen = False
        self.poses_frozen = False
        self.norm_pw_scale = True

    # ------------------------------------------------------------------
    # host-side initialization
    # ------------------------------------------------------------------

    def _cut(self, arr, v):
        """Slice a canvas map down to image v's true raster (no-op for
        uniform-shape scenes)."""
        h, w = self.shapes[v]
        return arr[:h, :w]

    def _edge_scores(self):
        return {
            (i, j): float(self._cut(self.preds.conf_i[e], i).mean()
                          * self._cut(self.preds.conf_j[e], j).mean())
            for e, (i, j) in enumerate(self.edges)
        }

    def _set_pose(self, arr, idx, R, T, scale=None):
        q = rotmat_to_qvec(np.asarray(R, np.float64))
        arr[idx, 0:4] = q
        # translation stored divided by scale (base_opt.py:172): the decode
        # multiplies the whole [:3] rows — rotation AND translation — by the
        # normalized pairwise scale (base_opt.py:190-196 get_pw_poses).
        arr[idx, 4:7] = G.signed_log1p(
            np.asarray(T, np.float64) / (scale or 1.0))
        if scale is not None:
            arr[idx, 7] = np.log(float(scale))

    def init_mst(self, focal_avg=False, known_focal=None, niter_pnp=10):
        """Confidence-MST initialization (init_im_poses.py:66-221)."""
        E = len(self.edges)
        scores = self._edge_scores()
        graph = sp.dok_array((self.n_imgs, self.n_imgs))
        for e, v in scores.items():
            graph[e] = -v
        msp = sp.csgraph.minimum_spanning_tree(graph.tocsr()).tocoo()

        # per-edge views cut to the owning image's true raster (mixed-
        # aspect canvases carry conf-1.0 padding that must not feed the
        # host-side registrations)
        pred_i = {e: self._cut(self.preds.pred_i[k], e[0])
                  for e, k in self.edge_index.items()}
        pred_j = {e: self._cut(self.preds.pred_j[k], e[1])
                  for e, k in self.edge_index.items()}
        conf_i = {e: self._cut(self.preds.conf_i[k], e[0])
                  for e, k in self.edge_index.items()}
        conf_j = {e: self._cut(self.preds.conf_j[k], e[1])
                  for e, k in self.edge_index.items()}

        pts3d = [None] * self.n_imgs
        im_poses = [None] * self.n_imgs
        im_focals = [None] * self.n_imgs

        todo = sorted(zip(-msp.data, msp.row, msp.col))
        _, i, j = todo.pop()
        i, j = int(i), int(j)
        if (i, j) not in pred_i:
            i, j = j, i
        pts3d[i] = pred_i[(i, j)].copy()
        pts3d[j] = pred_j[(i, j)].copy()
        done = {i, j}
        im_poses[i] = np.eye(4)
        im_focals[i] = G.estimate_focal_weiszfeld(pred_i[(i, j)])
        msp_edges = [(i, j)]

        while todo:
            _, i, j = todo.pop()
            i, j = int(i), int(j)
            if (i, j) not in pred_i:
                i, j = j, i
            if i in done and j not in done:
                pass
            elif j in done and i not in done:
                i, j = j, i  # process from the known side
                if (i, j) not in pred_i:
                    # directed edge missing (non-symmetrized graph): defer
                    todo.insert(0, (0, i, j))
                    continue
            elif i in done and j in done:
                continue
            else:
                todo.insert(0, (0, i, j))
                continue
            e = (i, j)
            if im_focals[i] is None:
                im_focals[i] = G.estimate_focal_weiszfeld(pred_i[e])
            s, R, T = G.rigid_points_registration(
                pred_i[e], pts3d[i], conf=conf_i[e])
            trf = G.sRT_to_4x4(s, R, T)
            pts3d[j] = G.geotrf(trf, pred_j[e])
            done.add(j)
            msp_edges.append((i, j))
            if im_poses[i] is None:
                im_poses[i] = G.sRT_to_4x4(1.0, R, T)

        # complete missing focals from the best-scoring edge
        by_score = sorted(scores, key=scores.get, reverse=True)
        for i, j in by_score:
            if im_focals[i] is None:
                im_focals[i] = G.estimate_focal_weiszfeld(pred_i[(i, j)])
        # complete missing poses: RANSAC-PnP of the fused world pointmap
        # against the pixel grid (reference init_im_poses.py:259-299), with
        # the dense conf-weighted registration as fallback when PnP finds
        # no consensus (see module docstring)
        for n in range(self.n_imgs):
            if im_poses[n] is None and pts3d[n] is not None:
                conf_n = None
                for i, j in by_score:
                    if i == n:
                        conf_n = conf_i[(i, j)]
                        break
                if conf_n is not None:
                    msk = conf_n > self.min_conf_thr
                    if msk.sum() < pnp.MIN_PNP_POINTS:
                        msk = conf_n >= np.median(conf_n)
                    res = pnp.fast_pnp(pts3d[n], im_focals[n], msk,
                                        niter_pnp=niter_pnp)
                    if res is not None:
                        # keep BOTH outputs (init_im_poses.py:213
                        # `im_focals[i], im_poses[i] = res`): when the
                        # focal was unknown, fast_pnp's sweep estimated it
                        im_focals[n], im_poses[n] = (
                            float(res[0]), np.asarray(res[1]))  # cam2world
            if im_poses[n] is None:
                for i, j in by_score:
                    if i == n and pts3d[n] is not None:
                        s, R, T = G.rigid_points_registration(
                            pred_i[(i, j)], pts3d[n], conf=conf_i[(i, j)])
                        im_poses[n] = G.sRT_to_4x4(1.0, R, T)
                        break
            if im_poses[n] is None:
                im_poses[n] = np.eye(4)
        # images that never appear on the i-side of an edge can still have
        # no focal here (the completion loop keys pred_i by i, and PnP may
        # decline): Weiszfeld on the fused cloud in the now-known camera
        # frame, else the median of the known focals — never leave a None
        # for focal_avg's np.mean / _init_from_pts3d's focal write.
        known_f = [f for f in im_focals if f is not None]
        for n in range(self.n_imgs):
            if im_focals[n] is None:
                if pts3d[n] is not None:
                    cam_pts = G.geotrf(
                        np.linalg.inv(im_poses[n]),
                        np.asarray(pts3d[n], np.float64).reshape(-1, 3),
                    ).reshape(pts3d[n].shape)
                    im_focals[n] = G.estimate_focal_weiszfeld(cam_pts)
                elif known_f:
                    im_focals[n] = float(np.median(known_f))
        im_poses = np.stack(im_poses)

        if known_focal is not None:
            for n in range(self.n_imgs):
                im_focals[n] = float(known_focal)
            self.focals_frozen = True
        elif focal_avg:
            avg = float(np.mean(im_focals))
            for n in range(self.n_imgs):
                im_focals[n] = avg
            self.focals_frozen = True

        self._init_from_pts3d(pts3d, im_focals, im_poses)
        return msp_edges

    def _init_from_pts3d(self, pts3d, im_focals, im_poses):
        # per-edge sim3 onto the fused cloud (init_im_poses.py:92-133)
        for e, (i, j) in enumerate(self.edges):
            s, R, T = G.rigid_points_registration(
                self._cut(self.preds.pred_i[e], i), pts3d[i],
                conf=self._cut(self.preds.conf_i[e], i))
            self._set_pose(self.params["pw_poses"], e, R, T, scale=s)

        if self.norm_pw_scale:
            s_factor = float(np.exp(
                np.log(self.base_scale)
                - self.params["pw_poses"][:, 7].mean()))
        else:
            s_factor = 1.0
        im_poses = np.array(im_poses, np.float64)
        im_poses[:, :3, 3] *= s_factor

        for i in range(self.n_imgs):
            cam2world = im_poses[i]
            pts_w = np.asarray(pts3d[i], np.float64) * s_factor
            depth = G.geotrf(np.linalg.inv(cam2world),
                             pts_w.reshape(-1, 3))[:, 2]
            log_d = np.log(np.clip(depth, 1e-8, None)).astype(np.float32)
            h, w = self.shapes[i]
            if (h, w) == (self.H, self.W):
                self.params["im_depth"][i] = log_d
            else:
                # canvas scatter: true raster at the top-left; padded
                # pixels hold the valid median (zero-weight in the loss,
                # but exp() of them must stay sane)
                canvas = np.full((self.H, self.W), np.median(log_d),
                                 np.float32)
                canvas[:h, :w] = log_d.reshape(h, w)
                self.params["im_depth"][i] = canvas.ravel()
            self._set_pose(self.params["im_poses"], i,
                           cam2world[:3, :3], cam2world[:3, 3])
            if im_focals[i] is not None:
                self.params["im_focals"][i] = (
                    self.focal_break * np.log(im_focals[i]))

    # ------------------------------------------------------------------
    # the optimization loop (PyTorch, on the aligner's device)
    # ------------------------------------------------------------------

    def _buffers(self, dev, edges=slice(None), area=slice(None)):
        """The loss's constant tensors, restricted to the edges `edges`
        and the pixels `area` (a rank's share under a mesh)."""
        gx, gy = np.meshgrid(np.arange(self.W), np.arange(self.H))
        grid = np.stack([gx, gy], -1).reshape(-1, 2)
        E = len(self.edges)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        # conf transform = log (base_opt.py:46 conf='log')
        return dict(
            grid=t(grid[area]),
            pp=t(self.pp),
            pred_i=t(self.preds.pred_i.reshape(E, self.area, 3)[edges, area]),
            pred_j=t(self.preds.pred_j.reshape(E, self.area, 3)[edges, area]),
            w_i=t(np.log(np.clip(self.preds.conf_i, 1e-8, None)).reshape(
                E, self.area)[edges, area]),
            w_j=t(np.log(np.clip(self.preds.conf_j, 1e-8, None)).reshape(
                E, self.area)[edges, area]),
            ei=t([i for i, _ in self.edges[edges]], torch.int64),
            ej=t([j for _, j in self.edges[edges]], torch.int64),
            edges=edges, area=area,
        )

    def _shares(self, mesh):
        """(edge slice, area slice) of this rank: the edges when the rank
        count divides E, else the pixels when it divides H*W, else None
        (every rank runs the whole loss, with JAX's warning)."""
        from instantsplat_tpu_torch.parallel import runtime

        _, rank, n = runtime.axis(mesh)
        e = len(self.edges)
        if e % n == 0:
            return slice(rank * e // n, (rank + 1) * e // n), slice(None)
        if self.area % n == 0:
            a = self.area
            return slice(None), slice(rank * a // n, (rank + 1) * a // n)
        logging.getLogger(__name__).warning(
            "aligner: neither %d edges nor %d pixels divide the %d-device "
            "mesh; running replicated (correct but unsharded).", e,
            self.area, n)
        return None

    def _unproject(self, params, buffers):
        """[V, A, 3] world points from the depth, focal and pose params."""
        focals = torch.exp(params["im_focals"] / self.focal_break)  # [V,1]
        depth = torch.exp(params["im_depth"][:, buffers["area"]])  # [V,A]
        xy = buffers["grid"][None] - buffers["pp"][:, None, :]
        rel = torch.cat([depth[..., None] * xy / focals[..., None],
                         depth[..., None]], -1)  # [V,A,3]
        R = T.quat_to_rotmat(T.quat_normalize(params["im_poses"][:, :4]))
        t = G.signed_expm1(params["im_poses"][:, 4:7])
        return _rotate(rel, R) + t[:, None, :]

    def _loss(self, params, buffers):
        world = self._unproject(params, buffers)
        Rw = T.quat_to_rotmat(T.quat_normalize(params["pw_poses"][:, :4]))
        logs = params["pw_poses"][:, 7]
        scale = torch.exp(logs)
        if self.norm_pw_scale:
            scale = scale * torch.exp(math.log(self.base_scale)
                                      - torch.mean(logs))
        # scale multiplies rotation AND translation (get_pw_poses)
        Rs = (Rw * scale[:, None, None])[buffers["edges"]]
        tw = (G.signed_expm1(params["pw_poses"][:, 4:7])
              * scale[:, None])[buffers["edges"]]
        ai = _rotate(buffers["pred_i"], Rs) + tw[:, None, :]
        aj = _rotate(buffers["pred_j"], Rs) + tw[:, None, :]

        def dist(a, b):  # l1_dist with a grad-safe norm at exactly 0
            d = a - b
            return torch.sqrt(torch.sum(d * d, -1) + 1e-16)

        total = float(len(self.edges) * self.area)
        li = torch.sum(dist(world[buffers["ei"]], ai) * buffers["w_i"])
        lj = torch.sum(dist(world[buffers["ej"]], aj) * buffers["w_j"])
        return li / total + lj / total

    def align(self, niter=300, lr=0.01, lr_min=1e-6, schedule="cosine",
              mesh=None):
        """Adam over all parameter groups for `niter` iterations on the
        aligner's device; returns the final loss. Frozen groups (preset
        poses, averaged or known focals) keep their values but their
        moments still update, as in the JAX loop. `mesh`: shard the edges
        (or the pixels) over the ranks of its first axis; every rank ends
        with the same parameters and loss."""
        dev = resolve_device(self.device)
        groups, shares = None, None
        if mesh is not None:
            from instantsplat_tpu_torch.parallel import runtime

            # one start for every rank: rank 0's
            self.params = runtime.broadcast_object(self.params,
                                                   runtime.axis(mesh)[0])
            shares = self._shares(mesh)
            if shares is not None:
                groups = [runtime.axis(mesh)[0]]
        buffers = self._buffers(dev, *(shares or ()))
        params = {k: torch.tensor(v, device=dev).requires_grad_()
                  for k, v in self.params.items()}
        trainable = dict(pw_poses=True, im_poses=not self.poses_frozen,
                         im_depth=True, im_focals=not self.focals_frozen)
        beta1, beta2, eps = 0.9, 0.9, 1e-8
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        # the rate and the bias corrections of every iteration in float32,
        # as JAX's loop computes them on the device: one table, indexed by
        # a device step counter
        f32 = np.float32
        table = np.zeros((niter, 3), f32)
        for it in range(niter):
            t = f32(it) / f32(niter)
            if schedule == "cosine":
                table[it, 0] = f32(lr_min) + (f32(lr) - f32(lr_min)) * (
                    f32(1) + np.cos(t * f32(math.pi))) / f32(2)
            else:
                table[it, 0] = f32(lr) + (f32(lr_min) - f32(lr)) * t
            table[it, 1] = f32(1) - f32(beta1) ** f32(it + 1)
            table[it, 2] = f32(1) - f32(beta2) ** f32(it + 1)
        table = StepTable(table, dev)

        def step():
            cur_lr, bc1, bc2 = table.row()
            grads = torch.autograd.grad(self._loss(params, buffers),
                                        list(params.values()))
            if groups is not None:
                grads = runtime.all_reduce_flat(grads, groups)
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                    v[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                    if trainable[k]:
                        p.sub_(cur_lr * (m[k] / bc1) / (
                            torch.sqrt(v[k] / bc2) + eps))
                table.advance()

        # JAX's fori_loop blocks: on a card, replays of one captured step,
        # with a mesh its all-reduce too
        StepLoop(step, dev, "align", groups=groups).run(niter)
        with torch.no_grad():
            final_loss = self._loss(params, buffers)
            if groups is not None:
                final_loss = runtime.all_reduce_flat([final_loss], groups)[0]
        self.params = {k: p.detach().cpu().numpy()
                       for k, p in params.items()}
        return float(final_loss)

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------

    def get_focals(self):
        return np.exp(
            self.params["im_focals"][:, 0] / self.focal_break)

    def get_intrinsics(self):
        K = np.zeros((self.n_imgs, 3, 3))
        f = self.get_focals()
        K[:, 0, 0] = K[:, 1, 1] = f
        K[:, :2, 2] = self.pp
        K[:, 2, 2] = 1
        return K

    def get_im_poses(self):
        """[V, 4, 4] cam-to-world."""
        return np.stack([
            _pose7_to_c2w_np(p) for p in self.params["im_poses"]])

    def get_depthmaps(self):
        return np.exp(self.params["im_depth"]).reshape(
            self.n_imgs, self.H, self.W)

    def get_log_depthmaps(self):
        """Raw log-depth params — what init_geo.py:58 passes to the co-vis
        mask computation (reference quirk: un-exponentiated)."""
        return self.params["im_depth"].reshape(self.n_imgs, self.H, self.W)

    def get_valid_masks(self):
        """[V, H, W] bool: True on each image's true raster (all-True for
        uniform-shape scenes; mixed-aspect canvases mask the padding)."""
        gy, gx = np.mgrid[:self.H, :self.W]
        return ((gy[None] < self.shapes[:, 0, None, None])
                & (gx[None] < self.shapes[:, 1, None, None]))

    def mask_sky(self, images):
        """Zero sky-pixel confidence (reference base_opt.py:288-295):
        returns a deep copy of this aligner whose im_conf is zeroed
        wherever eval.viz.segment_sky fires on the corresponding image.

        `images`: [V] sequence of [h, w, 3] RGB rasters in [0, 1] floats
        or uint8 (the aligner keeps only the predictions, so the caller
        passes them). On a mixed-aspect canvas a raster smaller than the
        canvas masks only its true extent."""
        import copy

        from instantsplat_tpu_torch.eval.viz import segment_sky

        res = copy.deepcopy(self)
        for i in range(self.n_imgs):
            sky = segment_sky(np.asarray(images[i]))
            res.im_conf[i][:sky.shape[0], :sky.shape[1]][sky] = 0.0
        return res

    def get_pts3d(self):
        """[V, H, W, 3] world-space pointmaps."""
        f = self.get_focals()[:, None, None]
        depth = self.get_depthmaps()
        gx, gy = np.meshgrid(np.arange(self.W), np.arange(self.H))
        xy = np.stack([gx, gy], -1)[None] - self.pp[:, None, None, :]
        rel = np.concatenate(
            [depth[..., None] * xy / f[..., None], depth[..., None]], -1)
        c2w = self.get_im_poses()
        return np.stack([
            G.geotrf(c2w[i], rel[i].reshape(-1, 3)).reshape(
                self.H, self.W, 3)
            for i in range(self.n_imgs)
        ])


def clean_pointcloud(im_confs, K, cams_w2c, depthmaps, all_pts3d,
                     tol=0.001, bad_conf=0.0):
    """Cross-view confidence suppression (base_opt.py:369-405): project each
    view's points into every other view; points landing IN FRONT of a more
    confident view's surface get their confidence clipped to `bad_conf`.

    im_confs [V,H,W]; K [V,3,3]; cams_w2c [V,4,4]; depthmaps [V,H,W];
    all_pts3d [V,H,W,3] world frame. Returns updated [V,H,W] confidences.
    """
    im_confs = np.array(im_confs, np.float64, copy=True)
    v, h, w = im_confs.shape
    for i in range(v):
        pts = np.asarray(all_pts3d[i]).reshape(-1, 3)
        for j in range(v):
            if i == j:
                continue
            pc = pts @ np.asarray(cams_w2c[j])[:3, :3].T \
                + np.asarray(cams_w2c[j])[:3, 3]
            z = pc[:, 2]
            uu = pc[:, 0] / np.where(z == 0, 1, z) * K[j][0, 0] + K[j][0, 2]
            vv = pc[:, 1] / np.where(z == 0, 1, z) * K[j][1, 1] + K[j][1, 2]
            u = np.round(uu).astype(int)
            vy = np.round(vv).astype(int)
            ok = (z > 0) & (u >= 0) & (u < w) & (vy >= 0) & (vy < h)
            ci = im_confs[i].reshape(-1)
            dj = np.asarray(depthmaps[j]).reshape(h, w)
            cj = im_confs[j]
            bad = np.zeros(len(pts), bool)
            bad[ok] = (z[ok] < (1 - tol) * dj[vy[ok], u[ok]]) & (
                ci[ok] < cj[vy[ok], u[ok]])
            ci[bad] = np.minimum(ci[bad], bad_conf)
            im_confs[i] = ci.reshape(h, w)
    return im_confs


def pair_scene_fast(preds: PairPrediction):
    """PairViewer-equivalent 2-view fast path (dust3r/cloud_opt/
    pair_viewer.py:18-90): no optimization — focals by Weiszfeld, the
    relative pose by dense conf-weighted sim3 registration of view j's
    pointmap-in-i's-frame onto j's own frame (replacing cv2 RANSAC-PnP as
    elsewhere in this module), anchored at whichever directed edge has the
    higher confidence product.

    Returns (c2w [2,4,4], focals [2], depthmaps [2,H,W], pts3d [2,H,W,3]).
    """
    assert preds.n_imgs == 2
    e = {edge: k for k, edge in enumerate(preds.edges)}
    assert (0, 1) in e and (1, 0) in e, "needs a symmetrized pair"
    confs = []
    focals = []
    rel_poses = []
    for i in range(2):
        k = e[(i, 1 - i)]
        confs.append(float(preds.conf_i[k].mean() * preds.conf_j[k].mean()))
        focals.append(G.estimate_focal_weiszfeld(preds.pred_i[k]))
        # pose of camera (1-i) in i's frame: register (1-i)'s own-frame
        # pointmap onto its pointmap expressed in i's frame
        k_rev = e[(1 - i, i)]
        s, R, T = G.rigid_points_registration(
            preds.pred_i[k_rev], preds.pred_j[k],
            conf=preds.conf_j[k])
        rel_poses.append(G.sRT_to_4x4(1.0, R, T))

    h, w = preds.imshape
    if confs[0] > confs[1]:
        k = e[(0, 1)]
        c2w = np.stack([np.eye(4), rel_poses[0]])
        pts0 = preds.pred_i[k]
        pts1 = preds.pred_j[k]
    else:
        k = e[(1, 0)]
        c2w = np.stack([rel_poses[1], np.eye(4)])
        pts1 = preds.pred_i[k]
        pts0 = preds.pred_j[k]
    pts3d = np.stack([pts0, pts1]).astype(np.float64)
    depth = np.stack([
        G.geotrf(np.linalg.inv(c2w[i]),
                 pts3d[i].reshape(-1, 3))[:, 2].reshape(h, w)
        for i in range(2)
    ])
    return c2w, np.array(focals), depth, pts3d


# --------------------------------------------------------------------------
# preset / freeze support (reference preset_pose / preset_focal /
# modular_optimizer's freezable per-image parameters)
# --------------------------------------------------------------------------


def _aligner_preset_pose(self, known_poses, pose_msk=None):
    """Fix (some) image poses to known c2w matrices and freeze them during
    align() (optimizer.py:68-82 preset_pose + modular_optimizer's
    per-image freezing, approximated at group granularity: poses are
    frozen when ALL are preset, matching the InstantSplat usage)."""
    idx = range(self.n_imgs) if pose_msk is None else pose_msk
    for k, i in enumerate(idx):
        m = np.asarray(known_poses[k], np.float64)
        self._set_pose(self.params["im_poses"], i, m[:3, :3], m[:3, 3])
    self.poses_frozen = (pose_msk is None
                         or len(list(pose_msk)) == self.n_imgs)
    # scale normalization is disabled once poses are known
    # (optimizer.py:79-82)
    if self.poses_frozen:
        self.norm_pw_scale = False


GlobalAligner.preset_pose = _aligner_preset_pose
