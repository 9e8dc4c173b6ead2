"""Depth refinement and triangulation (port of
instantsplat_tpu/init/depth_refine.py, the mast3r cloud_opt family).

- `tsdf_refine_depth`: the TSDF zero-level random search of
  tsdf_optimizer.py:34-112. Per pixel, candidate depths are sampled around
  the current estimate with a threshold-scaled spread, the
  confidence-weighted multi-view TSDF is evaluated at each candidate's 3D
  point, and the candidate whose |TSDF| is closest to zero is kept; a
  pixel whose every sample sits at the truncation floor is left as it is.
  Queries always read the ORIGINAL depth maps, so views refine
  independently. Where JAX vmaps over views and lax.maps over sample
  chunks, this loops over both. `torch.round` rounds half to even, as
  `jnp.round` does.
- `triangulate_matches`: midpoint triangulation of matched pixel pairs,
  numpy float64 (the JAX package's host code, copied).

The candidate offsets are the one random draw: `tsdf_refine_depth` draws
standard normals from a `torch.Generator` and hands them to `_refine`, so
a test can hand it JAX's draws instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device


def _tsdf_query(q, depthmaps, confs, K, w2c, curthresh: float):
    """[N,3] world points -> (tsdf [N], valid [N]); tsdf_optimizer.py:84-112.
    `curthresh` is a Python float, cast to float32 by each op as JAX's
    weak type is."""
    v, h, w = depthmaps.shape
    for j in range(v):
        pc = q @ w2c[j, :3, :3].T + w2c[j, :3, 3]
        z = pc[:, 2]
        uv = (pc[:, :2] / torch.clamp_min(z[:, None], 1e-6)
              * torch.stack([K[j, 0, 0], K[j, 1, 1]])
              + torch.stack([K[j, 0, 2], K[j, 1, 2]]))
        ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int32), 0, w - 1)
        vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int32), 0, h - 1)
        inside = ((uv[:, 0] >= -0.5) & (uv[:, 0] < w - 0.5)
                  & (uv[:, 1] >= -0.5) & (uv[:, 1] < h - 0.5) & (z > 0))
        flat = vi.long() * w + ui.long()
        sdf = depthmaps[j].reshape(-1)[flat] - z
        unseen = sdf < -curthresh  # visibility handling
        tsdf = torch.clamp_min(sdf, -curthresh)  # clip(-thresh, +inf)
        wgt = torch.where(inside & ~unseen, confs[j].reshape(-1)[flat],
                          torch.zeros_like(z))
        ts = tsdf * wgt if j == 0 else ts + tsdf * wgt
        ws = wgt if j == 0 else ws + wgt
    return ts / torch.clamp_min(ws, 1e-20), ws > 0


@torch.no_grad()
def _refine(depthmaps, K, c2w, confs, trunc: float, normals: list,
            sample_chunk: int):
    """The search, given its standard normals: normals[it] [V,H,W,S] for
    iteration `it`."""
    v, h, w = depthmaps.shape
    n_iter = len(normals)
    nsamples = normals[0].shape[-1]
    w2c = torch.linalg.inv(c2w)
    gy, gx = torch.meshgrid(torch.arange(h, device=depthmaps.device),
                            torch.arange(w, device=depthmaps.device),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1).float()  # [H,W,2]
    cs = nsamples // max(nsamples // sample_chunk, 1)  # JAX's chunking
    out = depthmaps
    for it in range(n_iter):
        curthresh = (n_iter - it) * trunc
        views = []
        for i in range(v):
            dm = out[i]
            newdm = dm[..., None] + (normals[it][i] - 1.0) * curthresh
            xy = ((grid - torch.stack([K[i, 0, 2], K[i, 1, 2]]))
                  / torch.stack([K[i, 0, 0], K[i, 1, 1]]))
            tsdf_abs = []
            for s in range(0, nsamples, cs):
                nd = newdm[..., s:s + cs]
                pts = torch.cat([xy[..., None, :] * nd[..., None],
                                 nd[..., None]], -1)
                pts = pts.reshape(-1, 3) @ c2w[i, :3, :3].T + c2w[i, :3, 3]
                tsdf, valid = _tsdf_query(pts, depthmaps, confs, K, w2c,
                                          curthresh)
                tsdf_abs.append(torch.where(
                    valid, torch.abs(tsdf),
                    torch.full_like(tsdf, torch.inf)).reshape(h, w, -1))
            tsdf_abs = torch.cat(tsdf_abs, -1)
            mins = torch.argmin(tsdf_abs, -1)
            # flat zone: every sample sits at the truncation floor
            allbad = torch.sum(tsdf_abs == curthresh, -1) == nsamples
            best = torch.take_along_dim(newdm, mins[..., None], -1)[..., 0]
            views.append(torch.where(allbad, dm, best))
        out = torch.stack(views)
    return out


def tsdf_refine_depth(depthmaps, intrinsics, c2w, confs=None, trunc=0.1,
                      n_iter: int = 1, nsamples: int = 128,
                      sample_chunk: int = 32, device="cuda",
                      generator: Optional[torch.Generator] = None):
    """depthmaps [V,H,W], intrinsics [V,3,3], c2w [V,4,4], confs [V,H,W]
    (linear weights) -> refined [V,H,W] float32 tensor on `device`.

    Iteration `it` searches with threshold (n_iter - it) * trunc and
    offsets (N(0,1) - 1) * threshold, the normals drawn from `generator`
    (default: a generator on `device` seeded with 0); the TSDF is
    clip(pred_depth - proj_depth, -threshold, +inf) averaged over the views
    where the point is seen and in bounds."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a), device=dev).float()

    depthmaps, K, c2w = f32(depthmaps), f32(intrinsics), f32(c2w)
    confs = torch.ones_like(depthmaps) if confs is None else f32(confs)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    normals = [torch.randn((*depthmaps.shape, nsamples), generator=generator,
                           device=dev) for _ in range(n_iter)]
    return _refine(depthmaps, K, c2w, confs, trunc, normals, sample_chunk)


def triangulate_matches(xy1, xy2, K1, K2, c2w1, c2w2):
    """Midpoint triangulation -> ([M,3] world points, [M] ray distances).

    The distance between the two closest ray points is the reprojection
    disagreement (an outlier score)."""
    def rays(xy, K, c2w):
        xy = np.asarray(xy, np.float64)
        d = np.stack([
            (xy[:, 0] - K[0, 2]) / K[0, 0],
            (xy[:, 1] - K[1, 2]) / K[1, 1],
            np.ones(len(xy)),
        ], -1)
        d = d @ np.asarray(c2w)[:3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(np.asarray(c2w)[:3, 3], d.shape)
        return o, d

    o1, d1 = rays(xy1, K1, c2w1)
    o2, d2 = rays(xy2, K2, c2w2)
    # closest points on the two lines: a 2x2 system per match
    b = o2 - o1
    d11 = np.sum(d1 * d1, -1)
    d12 = np.sum(d1 * d2, -1)
    d22 = np.sum(d2 * d2, -1)
    denom = d11 * d22 - d12 * d12
    denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
    t1 = (np.sum(b * d1, -1) * d22 - np.sum(b * d2, -1) * d12) / denom
    t2 = (np.sum(b * d1, -1) * d12 - np.sum(b * d2, -1) * d11) / denom
    p1 = o1 + t1[:, None] * d1
    p2 = o2 + t2[:, None] * d2
    return 0.5 * (p1 + p2), np.linalg.norm(p1 - p2, axis=-1)
