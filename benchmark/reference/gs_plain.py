"""Plain PyTorch reference of stage 2's training step (the gs_sh3 config).

Written from the rules of 3D Gaussian Splatting as InstantSplat trains it,
independent of the program: it imports torch and numpy only, and works out
again from the scene's raw arrays everything the program derives from them
(the KNN scales, the poses, the learning rates, the view order).

One step renders one training view with its learnable pose, takes
(1 - lambda) L1 + lambda (1 - SSIM) against the photo, and applies the
per-point Adam of InstantSplat's `pp_optimizer` to every leaf, pose
included:

- front end: covariance (R S)(R S)^T from the normalised quaternion; the
  view transform by the learnable w2c pose; camera-frame SH (degree 0 in
  the steps checked: the SH ramp adds a band every 1000 iterations); the
  EWA Jacobian at the frustum-clamped (1.3 tan(fov / 2)) position, which
  also gives the 2-D mean; the +0.3 px low-pass; the 3-sigma radius of the
  larger eigenvalue (floored at 0.1 under the root) for the screen test;
  the near cull z > 0.2 and det > 0;
- compositor: depth order; alpha = min(0.99, opacity exp(power)), skipped
  where power > 0 or alpha < 1/255; a pixel stops for good at the splat
  that would take its transmittance below 1e-4 (kept in log form);
  colour = sum of alpha T c, plus the final T times the background;
- SSIM: 11 x 11 Gaussian window, sigma 1.5, C1 = 0.01^2, C2 = 0.03^2,
  zero padding;
- Adam: per leaf m, v; no moment update for a leaf whose whole gradient is
  zero; step lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps), times the
  per-point rate (1 - sigmoid(confidence)) * 99 + 1 on the means; the
  means' rate decays log-linearly over 30k steps from 1.6e-4 to 1.6e-6 of
  the camera extent, the poses' over the run from 1e-4 to 1e-6.

The compositor is evaluated per 16 x 16 tile over the splats whose alpha
>= 1/255 ellipse meets the tile, in blocks of tiles; the gradient comes from
autograd, through a recomputation per block of tiles. `dtype` sets the
precision of everything: float32 is the reference, bfloat16 the control.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

C0 = 0.28209479177387814  # SH band 0
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_STOP = math.log(1e-4)
NEAR_Z = 0.2
LOW_PASS = 0.3
TILE = 16
TILE_BLOCK = 48  # tiles per compositor block
LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "cam_poses")


@contextlib.contextmanager
def full_float32():
    """TF32 off for matmuls and convolutions, as a float32 reference needs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


# --------------------------------------------------------------------------
# the start: what stage 2 builds from the scene folder
# --------------------------------------------------------------------------


def knn_mean_dist2(pts: torch.Tensor, k: int = 3,
                   chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, floored at
    1e-7. The points are taken in order of x, a chunk at a time. The k-th
    nearest within the chunk bounds each of its points' k-th nearest
    distance by some r, so every nearer point lies in the slab of x within
    r of the chunk: candidates from the Gram form over that slab, then
    exact differences."""
    pts = pts - pts.mean(0, keepdim=True)
    n = pts.shape[0]
    order = torch.argsort(pts[:, 0])
    sp = pts[order]
    xs = sp[:, 0].contiguous()
    sq = (sp * sp).sum(1)
    out = torch.empty(n, dtype=pts.dtype, device=pts.device)
    with full_float32():
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            q = sp[s:e]
            rows = torch.arange(e - s, device=pts.device)
            r = float("inf")
            if e - s > k:
                own = ((q[:, None, :] - q[None, :, :]) ** 2).sum(-1)
                own[rows, rows] = float("inf")
                r2 = torch.topk(own, k, dim=1, largest=False).values.max()
                r = math.sqrt(float(r2)) * 1.01 + 1e-6
            lo = int(torch.searchsorted(xs, xs[s:s + 1] - r))
            hi = int(torch.searchsorted(xs, xs[e - 1:e] + r, right=True))
            cols, me = sp[lo:hi], rows + (s - lo)
            d2 = sq[s:e, None] + sq[None, lo:hi] - 2.0 * (q @ cols.T)
            d2[rows, me] = float("inf")
            cand = torch.topk(d2, min(k + 4, hi - lo - 1), dim=1,
                              largest=False).indices
            exact = ((q[:, None, :] - cols[cand]) ** 2).sum(-1)
            exact = torch.where(cand == me[:, None],
                                torch.full_like(exact, float("inf")), exact)
            out[order[s:e]] = torch.topk(exact, k, dim=1,
                                         largest=False).values.mean(1)
    return torch.clamp(out, min=1e-7)


def initial_state(scene, sh_degree: int, init_opacity: float, device,
                  dtype=torch.float32) -> dict:
    """The leaves stage 2 starts from, worked out from the scene's arrays."""
    xyz = torch.as_tensor(scene.xyz, dtype=torch.float32, device=device)
    n = xyz.shape[0]
    rgb = torch.as_tensor(scene.rgb8, dtype=torch.float32,
                          device=device) / 255.0
    scale = torch.log(torch.sqrt(knn_mean_dist2(xyz)))
    q = torch.as_tensor(scene.qvecs, dtype=torch.float64)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    q = torch.where(q[:, :1] < 0, -q, q)
    poses = torch.cat([q, torch.as_tensor(scene.tvecs, dtype=torch.float64)],
                      1)
    k_sh = (sh_degree + 1) ** 2
    leaves = dict(
        xyz=xyz,
        features_dc=((rgb - 0.5) / C0)[:, None, :],
        features_rest=torch.zeros((n, k_sh - 1, 3), device=device),
        scaling=scale[:, None].repeat(1, 3),
        rotation=torch.tensor([1.0, 0.0, 0.0, 0.0],
                              device=device).repeat(n, 1),
        opacity=torch.full((n, 1), math.log(init_opacity / (1 - init_opacity)),
                           device=device),
        cam_poses=poses.to(device=device, dtype=torch.float32),
    )
    return {k: v.to(dtype) for k, v in leaves.items()}


def camera_extent(scene) -> float:
    """1.1 times the largest distance of a camera centre from their mean."""
    centres = []
    for q, t in zip(scene.qvecs, scene.tvecs):
        R = quat_to_rotmat(torch.as_tensor(q, dtype=torch.float64)).numpy()
        centres.append(-R.T @ np.asarray(t, np.float64))
    c = np.stack(centres)
    return float(1.1 * np.linalg.norm(c - c.mean(0), axis=1).max())


def view_order(n_views: int, n_steps: int, seed: int = 0) -> list:
    """Views drawn without replacement per epoch, each epoch's order a
    permutation of numpy's RandomState(seed), taken from its end."""
    rng = np.random.RandomState(seed)
    queue, out = [], []
    for _ in range(n_steps):
        if not queue:
            queue = list(rng.permutation(n_views))
        out.append(int(queue.pop()))
    return out


class Schedule:
    """Learning rates by iteration and leaf (config keys of gs_sh3.json)."""

    def __init__(self, cfg: dict, extent: float):
        self.cfg = cfg
        self.extent = extent

    @staticmethod
    def _loglin(lr0, lr1, step, max_steps):
        t = min(max(step / max_steps, 0.0), 1.0)
        return math.exp(math.log(lr0) * (1 - t) + math.log(lr1) * t)

    def lrs(self, iteration: int) -> dict:
        c = self.cfg
        return dict(
            xyz=self._loglin(c["position_lr_init"] * self.extent,
                             c["position_lr_final"] * self.extent,
                             iteration, c["position_lr_max_steps"]),
            features_dc=c["feature_lr"] * 10.0,
            features_rest=c["feature_lr"] / 20.0 * 10.0,
            opacity=c["opacity_lr"],
            scaling=c["scaling_lr"] * 10.0,
            rotation=c["rotation_lr"] * 10.0,
            cam_poses=self._loglin(c["rotation_lr"] * 0.1,
                                   c["rotation_lr"] * 0.001, iteration,
                                   c["iterations"]),
        )


# --------------------------------------------------------------------------
# one render
# --------------------------------------------------------------------------


def project(leaves: dict, pose: torch.Tensor, fx: float, fy: float,
            height: int, width: int):
    """-> (columns [N, 9]: mx, my, conic a b c, log-opacity, r, g, b;
    depth [N]; valid [N]; the 2-D covariance's a, c [N] for the tiles)."""
    xyz = leaves["xyz"]
    dt = xyz.dtype
    R = quat_to_rotmat(pose[:4])
    t = pose[4:7]
    x, y, z = xyz.unbind(1)
    vx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    vy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    vz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]

    col = torch.clamp(C0 * leaves["features_dc"][:, 0, :] + 0.5, min=0.0)

    Rg = quat_to_rotmat(leaves["rotation"])  # [N, 3, 3]
    M = Rg * torch.exp(leaves["scaling"])[:, None, :]
    cov = M @ M.transpose(1, 2)

    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    limx = 1.3 * width / (2.0 * fx)
    limy = 1.3 * height / (2.0 * fy)
    zs = torch.where(vz.abs() < 1e-8, torch.full_like(vz, 1e-8), vz)
    tx = torch.clamp(vx / zs, -limx, limx) * vz
    ty = torch.clamp(vy / zs, -limy, limy) * vz
    zero = torch.zeros_like(vz)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
                     torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1)],
                    -2)  # [N, 2, 3]
    T = J @ R.to(dt)
    cov2 = T @ cov @ T.transpose(1, 2)
    a = cov2[:, 0, 0] + LOW_PASS
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + LOW_PASS
    det = a * c - b * b
    det_ok = det > 0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    mx = fx * tx / zs + cx
    my = fy * ty / zs + cy
    valid = ((vz > NEAR_Z) & det_ok & (mx + radius > 0) & (mx - radius < width)
             & (my + radius > 0) & (my - radius < height))
    log_op = F.logsigmoid(leaves["opacity"][:, 0])
    cols = torch.stack([mx, my, c * inv_det, -b * inv_det, a * inv_det,
                        log_op, col[:, 0], col[:, 1], col[:, 2]], 1)
    return cols, vz, valid, a, c


def tile_lists(cols, depth, valid, a, c, height, width):
    """Splats in depth order per tile: (order of the valid splats [M], the
    entries' splat positions in that order [E], tile starts [T + 1])."""
    dev = cols.device
    idx = torch.nonzero(valid).squeeze(1)
    order = idx[torch.sort(depth[idx].float(), stable=True).indices]
    mx, my, lo = (cols[order, 0].float(), cols[order, 1].float(),
                  cols[order, 5].float())
    m = lo - math.log(ALPHA_MIN)  # alpha >= 1/255 needs d^T C d <= 2 m
    keep = m > 0
    rx = torch.sqrt(2.0 * torch.clamp(m, min=0) * a[order].float()) * 1.01 + 1
    ry = torch.sqrt(2.0 * torch.clamp(m, min=0) * c[order].float()) * 1.01 + 1
    ntx, nty = -(-width // TILE), -(-height // TILE)
    x0 = torch.clamp(torch.floor((mx - rx) / TILE), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor((mx + rx) / TILE), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor((my - ry) / TILE), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor((my + ry) / TILE), 0, nty - 1).long()
    keep &= (mx + rx >= 0) & (mx - rx < width) & (my + ry >= 0) & (
        my - ry < height)
    pos = torch.nonzero(keep).squeeze(1)
    nx = (x1 - x0 + 1)[pos]
    ny = (y1 - y0 + 1)[pos]
    cnt = nx * ny
    ent = torch.repeat_interleave(pos, cnt)
    first = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(ent.shape[0], device=dev) - torch.repeat_interleave(
        first, cnt)
    nxe = torch.repeat_interleave(nx, cnt)
    tx = x0[ent] + within % nxe
    ty = y0[ent] + within // nxe
    tile = ty * ntx + tx
    key = tile * (order.shape[0] + 1) + ent
    srt = torch.sort(key).indices
    ent, tile = ent[srt], tile[srt]
    starts = torch.searchsorted(tile, torch.arange(ntx * nty + 1,
                                                   device=dev))
    return order, ent, starts


def _tile_terms(rows, ent, starts, t0, t1, width):
    """For tiles t0 .. t1 - 1: (the splat rows [B, M, 9], alpha, log(1 -
    alpha), the transmittance's log after each splat, and which splats
    contribute [B, 256, M])."""
    dev, dt = rows.device, rows.dtype
    ntx = -(-width // TILE)
    lens = starts[t0 + 1:t1 + 1] - starts[t0:t1]
    mlen = max(int(lens.max()), 1)
    slot = torch.arange(mlen, device=dev)
    present = slot[None, :] < lens[:, None]
    gather = torch.where(present, starts[t0:t1, None] + slot[None, :],
                         torch.zeros_like(slot)[None, :])
    blk = rows[ent[gather]]  # [B, M, 9]
    tiles = torch.arange(t0, t1, device=dev)
    pix = torch.arange(TILE * TILE, device=dev)
    px = ((tiles % ntx) * TILE)[:, None] + (pix % TILE)[None, :]
    py = ((tiles // ntx) * TILE)[:, None] + (pix // TILE)[None, :]
    dx = px.to(dt)[:, :, None] - blk[:, None, :, 0]
    dy = py.to(dt)[:, :, None] - blk[:, None, :, 1]
    power = (-0.5 * (blk[:, None, :, 2] * dx * dx + blk[:, None, :, 4] * dy
                     * dy) - blk[:, None, :, 3] * dx * dy)
    alpha = torch.clamp(torch.exp(power + blk[:, None, :, 5]), max=ALPHA_MAX)
    ok = present[:, None, :] & (power <= 0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
    lg = torch.log1p(-alpha)
    post = torch.cumsum(lg, -1)
    fired = ok & (post < LOG_T_STOP)
    stopped = torch.cumsum(fired.int(), -1) > 0
    return blk, alpha, lg, post, ok & ~stopped


def _composite_tiles(rows, ent, starts, t0, t1, height, width, bg):
    """Colours [B, 256, 3] of tiles t0 .. t1 - 1 from sorted splat rows."""
    blk, alpha, lg, post, use = _tile_terms(rows, ent, starts, t0, t1, width)
    w = torch.where(use, alpha * torch.exp(post - lg), torch.zeros_like(alpha))
    rgb = w @ blk[:, :, 6:9]  # [B, 256, 3]
    t_fin = torch.exp(torch.where(use, lg, torch.zeros_like(lg)).sum(-1))
    return rgb + t_fin[..., None] * bg


def contributing(rows, ent, starts, t0, t1, height, width) -> int:
    """Contributing (pixel, splat) pairs of tiles t0 .. t1 - 1, counting
    only pixels inside the image."""
    use = _tile_terms(rows, ent, starts, t0, t1, width)[4]
    ntx = -(-width // TILE)
    tiles = torch.arange(t0, t1, device=rows.device)
    pix = torch.arange(TILE * TILE, device=rows.device)
    inside = ((((tiles % ntx) * TILE)[:, None] + (pix % TILE)[None, :] < width)
              & (((tiles // ntx) * TILE)[:, None] + (pix // TILE)[None, :]
                 < height))
    return int((use & inside[:, :, None]).sum())


def _tiles_to_image(tile_rgb, height, width):
    ntx, nty = -(-width // TILE), -(-height // TILE)
    img = tile_rgb.reshape(nty, ntx, TILE, TILE, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(nty * TILE, ntx * TILE, 3)[:height, :width]


def render(rows, ent, starts, height, width, bg):
    ntx, nty = -(-width // TILE), -(-height // TILE)
    parts = [_composite_tiles(rows, ent, starts, t0,
                              min(t0 + TILE_BLOCK, ntx * nty), height, width,
                              bg)
             for t0 in range(0, ntx * nty, TILE_BLOCK)]
    return _tiles_to_image(torch.cat(parts), height, width)


def _window(dtype, device):
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    g = torch.as_tensor(g / g.sum(), dtype=dtype, device=device)
    return (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()


def ssim(img, gt):
    """Mean SSIM of [H, W, 3] images."""
    x, y = img.permute(2, 0, 1)[None], gt.permute(2, 0, 1)[None]
    win = _window(img.dtype, img.device)

    def blur(v):
        return F.conv2d(v, win, padding=5, groups=3)

    mu1, mu2 = blur(x), blur(y)
    s11 = blur(x * x) - mu1 * mu1
    s22 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def photometric_loss(img, gt, lambda_dssim: float, rows_kept=None):
    """(1 - lambda) L1 + lambda (1 - SSIM); rows_kept (a fault for the
    control runs) takes the loss over the first rows_kept image rows."""
    if rows_kept is not None:
        img, gt = img[:rows_kept], gt[:rows_kept]
    return ((1.0 - lambda_dssim) * (img - gt).abs().mean()
            + lambda_dssim * (1.0 - ssim(img, gt)))


def loss_and_grads(leaves: dict, view: int, gt, fx, fy, lambda_dssim,
                   rows_kept=None):
    """-> (loss, {leaf: gradient}) of one view: the image without a
    gradient, its loss's gradient, then each block of tiles recomputed with
    a gradient into the splat rows, and the rows' gradient back through
    the front end to the leaves."""
    height, width = gt.shape[:2]
    dt = leaves["xyz"].dtype
    bg = torch.zeros(3, dtype=dt, device=gt.device)
    with full_float32():
        leaf_t = {k: v.detach().requires_grad_(True) for k, v in
                  leaves.items()}
        cols, depth, valid, a, c = project(leaf_t, leaf_t["cam_poses"][view],
                                           fx, fy, height, width)
        with torch.no_grad():
            order, ent, starts = tile_lists(cols, depth, valid, a, c,
                                             height, width)
        rows = cols[order]
        rows_d = rows.detach().requires_grad_(True)
        with torch.no_grad():
            img = render(rows_d, ent, starts, height, width, bg)
        img.requires_grad_(True)
        loss = photometric_loss(img, gt, lambda_dssim, rows_kept)
        (d_img,) = torch.autograd.grad(loss, img)
        ntx, nty = -(-width // TILE), -(-height // TILE)
        pad = torch.zeros((nty * TILE, ntx * TILE, 3), dtype=dt,
                          device=gt.device)
        pad[:height, :width] = d_img
        d_tiles = pad.reshape(nty, TILE, ntx, TILE, 3).permute(
            0, 2, 1, 3, 4).reshape(nty * ntx, TILE * TILE, 3)
        for t0 in range(0, ntx * nty, TILE_BLOCK):
            t1 = min(t0 + TILE_BLOCK, ntx * nty)
            out = _composite_tiles(rows_d, ent, starts, t0, t1, height,
                                   width, bg)
            out.backward(d_tiles[t0:t1])
        rows.backward(rows_d.grad)
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaf_t.items()}
    return loss.detach(), grads


def adam_step(leaves, m, v, grads, step: int, lrs: dict, per_point_lr,
              beta1=0.9, beta2=0.999, eps=1e-15):
    """Per-point Adam, in place on leaves, m and v (step counts from 1)."""
    corr = math.sqrt(1.0 - beta2 ** step) / (1.0 - beta1 ** step)
    for k in LEAVES:
        g = grads[k]
        if bool((g != 0).any()):
            m[k].mul_(beta1).add_((1 - beta1) * g)
            v[k].mul_(beta2).add_((1 - beta2) * g * g)
        upd = (lrs[k] * corr) * m[k] / (torch.sqrt(v[k]) + eps)
        if k == "xyz":
            upd = upd * per_point_lr
        leaves[k].sub_(upd.to(leaves[k].dtype))


def per_point_lr(confidence, device, dtype=torch.float32):
    conf = torch.as_tensor(confidence, dtype=torch.float32, device=device)
    return ((1.0 - torch.sigmoid(conf)) * 99.0 + 1.0)[:, None].to(dtype)


def follow(leaves, m, v, first_step: int, views, iterations, scene, cfg,
           extent, ppl, rows_kept=None):
    """Run len(views) steps from (leaves, m, v) after first_step - 1 steps,
    in place. -> (losses, the gradients of the first step)."""
    sched = Schedule(cfg, extent)
    dev, dt = leaves["xyz"].device, leaves["xyz"].dtype
    losses, first = [], None
    for j, (view, it) in enumerate(zip(views, iterations)):
        gt = torch.as_tensor(scene.images[view], device=dev).to(dt) / 255.0
        loss, grads = loss_and_grads(leaves, view, gt, scene.fx, scene.fx,
                                     cfg["lambda_dssim"], rows_kept)
        if first is None:
            first = {k: g.float() for k, g in grads.items()}
        adam_step(leaves, m, v, grads, first_step + j, sched.lrs(it), ppl)
        losses.append(float(loss))
    return losses, first
