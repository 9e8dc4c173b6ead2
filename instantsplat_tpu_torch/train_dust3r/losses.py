"""DUSt3R / MASt3R pre-training losses in PyTorch (port of
instantsplat_tpu/train_dust3r/losses.py).

`regr3d_conf_loss` is ConfLoss(Regr3D(L21, norm_mode='avg_dis')) with the
reference's variants (normalisation off or GT kept metric, distance
clipping, shift- and scale-invariance, MASt3R's metric-scale mode, sky
pixels, log-compressed norms); `matching_loss` is MASt3R's InfoNCE
descriptor matching over GT correspondences, optionally confidence
weighted; `mast3r_finetune_loss` adds the two. Masks are applied as
masked means over static shapes, as in the JAX package, so every batch
element keeps its pixels.

Where PyTorch and JAX differ in a way that shows:
- medians are `torch.nanquantile(x, 0.5)`: `torch.nanmedian` returns the
  lower of the two middle values of an even count, JAX (like numpy)
  their mean;
- `jax.lax.stop_gradient` is `.detach()`;
- `jnp.maximum` / `jnp.minimum` are `torch.maximum` / `torch.minimum`,
  never `torch.clamp`: at a tie clamp passes the whole gradient where JAX
  splits it.
"""

from __future__ import annotations

import torch

from instantsplat_tpu_torch.init.geometry import geotrf


def _max(x, c):
    return torch.maximum(x, x.new_full((), c))


def _masked_mean(x, mask, axis=None, eps=1e-8):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if axis is None:
        num = torch.where(mask, x, zero).sum()
        den = mask.to(x.dtype).sum()
    else:
        num = torch.where(mask, x, zero).sum(axis)
        den = mask.to(x.dtype).sum(axis)
    return num / _max(den, eps)


def _norm(x, keepdim=False):
    return torch.linalg.norm(x, dim=-1, keepdim=keepdim)


def _nan_where(mask, x):
    return torch.where(mask, x, torch.full((), float("nan"), dtype=x.dtype,
                                           device=x.device))


def normalize_pointcloud(pts1, pts2, valid1, valid2):
    """Joint 'avg_dis' normalisation: both pointmaps divided by the masked
    mean distance to the origin over BOTH views.
    pts: [B,H,W,3]; valid: [B,H,W]. -> (pts1, pts2, factor [B,1,1,1])."""
    b = pts1.shape[0]
    all_d = torch.cat([_norm(pts1).reshape(b, -1),
                       _norm(pts2).reshape(b, -1)], 1)
    all_m = torch.cat([valid1.reshape(b, -1), valid2.reshape(b, -1)], 1)
    factor = _max(_masked_mean(all_d, all_m, axis=1), 1e-8)
    factor = factor[:, None, None, None]
    return pts1 / factor, pts2 / factor, factor


def get_joint_pointcloud_depth(z1, z2, valid1, valid2, quantile=0.5):
    """Joint masked depth quantile over both views -> [B]."""
    b = z1.shape[0]
    nan1 = _nan_where(valid1, z1).reshape(b, -1)
    nan2 = _nan_where(valid2, z2).reshape(b, -1)
    return torch.nanquantile(torch.cat([nan1, nan2], -1), quantile, dim=-1)


def get_joint_pointcloud_center_scale(pts1, pts2, valid1, valid2,
                                      z_only=False, center=True):
    """Joint masked median centre [B,1,3] and median-norm scale
    [B,1,1,1], both detached."""
    b = pts1.shape[0]
    nan1 = _nan_where(valid1[..., None], pts1).reshape(b, -1, 3)
    nan2 = _nan_where(valid2[..., None], pts2).reshape(b, -1, 3)
    pts = torch.cat([nan1, nan2], 1)
    c = torch.nanquantile(pts, 0.5, dim=1, keepdim=True)  # [B,1,3]
    if z_only:
        c = torch.cat([torch.zeros_like(c[..., :2]), c[..., 2:]], -1)
    n = _norm((pts - c) if center else pts)
    scale = torch.nanquantile(n, 0.5, dim=1)
    return c.detach(), scale.detach()[:, None, None, None]


def find_opt_scaling(gt_pts1, gt_pts2, pr_pts1, pr_pts2,
                     fit_mode="weiszfeld_stop_grad",
                     valid1=None, valid2=None):
    """Per-batch scalar s minimising |pr - s*gt| over valid pixels: 'avg'
    closed-form L2, 'median' of per-pixel ratios, 'weiszfeld' 10-step
    IRLS; '*_stop_grad' detaches. -> [B], at least 1e-3."""
    b = gt_pts1.shape[0]

    def flat(p, v):
        p = p.reshape(b, -1, 3)
        m = (torch.ones(p.shape[:2], dtype=torch.bool, device=p.device)
             if v is None else v.reshape(b, -1))
        return p, m

    g1, m1 = flat(gt_pts1, valid1)
    g2, m2 = flat(gt_pts2, valid2)
    p1, _ = flat(pr_pts1, None)
    p2, _ = flat(pr_pts2, None)
    gt = torch.cat([g1, g2], 1)
    pr = torch.cat([p1, p2], 1)
    m = torch.cat([m1, m2], 1)

    dot_gp = (pr * gt).sum(-1)
    dot_gg = (gt * gt).sum(-1)
    if fit_mode.startswith("avg"):
        s = _masked_mean(dot_gp, m, 1) / _max(_masked_mean(dot_gg, m, 1),
                                              1e-12)
    elif fit_mode.startswith("median"):
        r = _nan_where(m, dot_gp / _max(dot_gg, 1e-12))
        s = torch.nanquantile(r, 0.5, dim=1)
    elif fit_mode.startswith("weiszfeld"):
        s = _masked_mean(dot_gp, m, 1) / _max(_masked_mean(dot_gg, m, 1),
                                              1e-12)
        for _ in range(10):
            dis = _norm(pr - s[:, None, None] * gt)
            w = 1.0 / _max(dis, 1e-8)
            s = _masked_mean(w * dot_gp, m, 1) / _max(
                _masked_mean(w * dot_gg, m, 1), 1e-12)
    else:
        raise ValueError(f"bad fit_mode {fit_mode}")
    if fit_mode.endswith("stop_grad"):
        s = s.detach()
    return _max(s, 1e-3)


def se3_inv(m):
    R = m[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", R, m[..., :3, 3])
    out = torch.zeros_like(m)
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def apply_log_to_norm(xyz):
    """Log-compress the radial norm (mast3r/losses.py:20-25)."""
    d = _norm(xyz, keepdim=True)
    return xyz / _max(d, 1e-8) * torch.log1p(d)


def _shift_z(pts, shift):
    return torch.cat([pts[..., :2], pts[..., 2:] - shift[:, None, None,
                                                          None]], -1)


def regr3d_conf_loss(gt1, gt2, pred1, pred2, alpha=0.2, norm_gt=True,
                     normalize=True, dist_clip=None,
                     shift_inv=False, scale_inv=False,
                     norm_all=True, max_metric_scale=0.0,
                     sky_loss_value=0.0, loss_in_log=False):
    """ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha), the DUSt3R
    pre-training objective, with the JAX package's variants (see its
    docstring): normalize / norm_gt, dist_clip, shift_inv, scale_inv,
    norm_all=False with gt1['is_metric_scale'] and max_metric_scale,
    sky_loss_value with gt['sky_mask'], loss_in_log 'before' or True.

    gt_k: dict(pts3d [B,H,W,3] world frame, camera_pose [B,4,4] c2w,
    valid_mask [B,H,W] bool); pred_k: dict(pts3d or pts3d_in_other_view,
    conf). -> (scalar loss, details dict)."""
    in_cam1 = se3_inv(gt1["camera_pose"])
    b = gt1["pts3d"].shape[0]
    gt_pts1 = geotrf(in_cam1, gt1["pts3d"].reshape(b, -1, 3)).reshape(
        gt1["pts3d"].shape)
    gt_pts2 = geotrf(in_cam1, gt2["pts3d"].reshape(b, -1, 3)).reshape(
        gt2["pts3d"].shape)
    valid1 = gt1["valid_mask"]
    valid2 = gt2["valid_mask"]
    if dist_clip is not None:
        valid1 = valid1 & (_norm(gt_pts1) <= dist_clip)
        valid2 = valid2 & (_norm(gt_pts2) <= dist_clip)

    if loss_in_log == "before":
        gt_pts1 = apply_log_to_norm(gt_pts1)
        gt_pts2 = apply_log_to_norm(gt_pts2)

    pr_pts1 = pred1["pts3d"]
    pr_pts2 = pred2.get("pts3d_in_other_view", pred2.get("pts3d"))

    metric = None
    if not norm_all:
        metric = gt1.get("is_metric_scale")
        if metric is None:
            metric = torch.zeros((b,), dtype=torch.bool,
                                 device=gt_pts1.device)
        if max_metric_scale:
            zero = torch.zeros((), dtype=gt_pts1.dtype,
                               device=gt_pts1.device)
            d1 = torch.where(valid1, _norm(gt_pts1), zero).reshape(
                b, -1).amax(1)
            d2 = torch.where(valid2, _norm(gt_pts2), zero).reshape(
                b, -1).amax(1)
            metric = metric & (d1 < max_metric_scale) \
                & (d2 < max_metric_scale)

    if normalize:
        pr_n1, pr_n2, _ = normalize_pointcloud(
            pr_pts1, pr_pts2, valid1, valid2)
        if metric is None:
            pr_pts1, pr_pts2 = pr_n1, pr_n2
        else:
            sel = metric[:, None, None, None]
            pr_pts1 = torch.where(sel, pr_pts1, pr_n1)
            pr_pts2 = torch.where(sel, pr_pts2, pr_n2)
        if norm_gt:
            gt_pts1, gt_pts2, gt_factor = normalize_pointcloud(
                gt_pts1, gt_pts2, valid1, valid2)
            if metric is not None:
                sel = metric[:, None, None, None]
                pr_pts1 = torch.where(sel, pr_pts1 / gt_factor, pr_pts1)
                pr_pts2 = torch.where(sel, pr_pts2 / gt_factor, pr_pts2)

    if shift_inv:
        gt_shift = get_joint_pointcloud_depth(
            gt_pts1[..., 2], gt_pts2[..., 2], valid1, valid2)
        pr_shift = get_joint_pointcloud_depth(
            pr_pts1[..., 2], pr_pts2[..., 2], valid1, valid2)
        gt_pts1 = _shift_z(gt_pts1, gt_shift)
        gt_pts2 = _shift_z(gt_pts2, gt_shift)
        pr_pts1 = _shift_z(pr_pts1, pr_shift)
        pr_pts2 = _shift_z(pr_pts2, pr_shift)
    if scale_inv:
        _, gt_scale = get_joint_pointcloud_center_scale(
            gt_pts1, gt_pts2, valid1, valid2)
        _, pr_scale = get_joint_pointcloud_center_scale(
            pr_pts1, pr_pts2, valid1, valid2)
        pr_scale = pr_scale.clamp(1e-3, 1e3)  # detached: no tie gradient
        if norm_gt:
            gt_pts1 = gt_pts1 / _max(gt_scale, 1e-12)
            gt_pts2 = gt_pts2 / _max(gt_scale, 1e-12)
            pr_pts1 = pr_pts1 / pr_scale
            pr_pts2 = pr_pts2 / pr_scale
        else:  # gt_scale=True: the prediction onto the GT scale
            pr_pts1 = pr_pts1 * gt_scale / pr_scale
            pr_pts2 = pr_pts2 * gt_scale / pr_scale

    if loss_in_log and loss_in_log != "before":
        pr_pts1, gt_pts1 = apply_log_to_norm(pr_pts1), apply_log_to_norm(
            gt_pts1)
        pr_pts2, gt_pts2 = apply_log_to_norm(pr_pts2), apply_log_to_norm(
            gt_pts2)
    l1 = _norm(pr_pts1 - gt_pts1)
    l2 = _norm(pr_pts2 - gt_pts2)

    if sky_loss_value > 0:
        sky1 = gt1.get("sky_mask")
        sky2 = gt2.get("sky_mask")
        if sky1 is not None:
            sky1 = sky1 & ~valid1
            l1 = torch.where(sky1, l1.new_full((), sky_loss_value), l1)
            valid1 = valid1 | sky1
        if sky2 is not None:
            sky2 = sky2 & ~valid2
            l2 = torch.where(sky2, l2.new_full((), sky_loss_value), l2)
            valid2 = valid2 | sky2

    conf1 = pred1["conf"]
    conf2 = pred2["conf"]
    cl1 = l1 * conf1 - alpha * torch.log(conf1)
    cl2 = l2 * conf2 - alpha * torch.log(conf2)
    loss = _masked_mean(cl1, valid1) + _masked_mean(cl2, valid2)
    details = dict(
        regr3d_1=_masked_mean(l1, valid1),
        regr3d_2=_masked_mean(l2, valid2),
        conf_loss_1=_masked_mean(cl1, valid1),
        conf_loss_2=_masked_mean(cl2, valid2),
    )
    return loss, details


# ---------------------------------------------------------------------------
# MASt3R descriptor matching loss (fine-tuning objective)
# ---------------------------------------------------------------------------


def get_similarities(desc1, desc2, euc=False):
    """[B,N,D] x [B,M,D] -> [B,N,M]: dot product, or 1/(1+euclidean)."""
    if euc:
        d = _norm(desc1[:, :, None] - desc2[:, None])
        return 1.0 / (1.0 + d)
    return torch.einsum("bnd,bmd->bnm", desc1, desc2)


def ap_matching_score(desc1, desc2, valid_matches=None, euc=False):
    """Average precision of the diagonal positives: with one positive per
    query, 1 / (1 + #negatives ranked strictly above it). Not
    differentiable (the reference computes it under no_grad)."""
    with torch.no_grad():
        scores = get_similarities(desc1.float(), desc2.float(), euc)
        pos = torch.diagonal(scores, dim1=-2, dim2=-1)  # [B, N]
        posrank = (scores > pos[:, :, None]).sum(-1)  # strict: ties go to
        # the positive, as a stable descending sort ranks them
        ap = 1.0 / (1.0 + posrank.float())
        if valid_matches is not None:
            v = valid_matches.bool()
            return torch.where(v, ap, 0.0).sum() / _max(
                v.sum().float(), 1.0)
        return ap.mean()


def infonce_matching_loss(desc1, desc2, valid_matches=None,
                          temperature=0.07, eps=1e-8, mode="proper",
                          euc=False, reduction="mean"):
    """InfoNCE over matched descriptor pairs (positives on the diagonal of
    each batch element's similarity matrix). Modes 'all' (one
    normalisation over the whole matrix), 'proper' / 'dual' (row and
    column normalisations). NaN similarities count as -inf; invalid rows
    stay in every denominator as distractors and only leave the sum of
    positive terms."""
    d1 = desc1.float()
    d2 = desc2.float()
    b, n, _ = d1.shape
    if valid_matches is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=d1.device)
    else:
        valid = valid_matches.bool()

    sim = get_similarities(d1, d2, euc) / temperature
    sim = torch.where(torch.isnan(sim), torch.full(
        (), float("-inf"), dtype=sim.dtype, device=sim.device), sim)
    log_pos = torch.diagonal(sim, dim1=-2, dim2=-1)  # [B, N]
    if mode == "all":
        denom = torch.logsumexp(sim, dim=(-1, -2))[:, None]
        loss = -(log_pos - denom)
    else:  # 'proper' / 'dual'
        loss = -((log_pos - torch.logsumexp(sim, dim=-2))
                 + (log_pos - torch.logsumexp(sim, dim=-1)))
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    if reduction == "none":
        return loss
    return loss.sum() / _max(valid.sum().to(loss.dtype), 1.0)


def matching_loss(gt1, gt2, pred1, pred2, withconf=False, use_pts3d=False,
                  temperature=0.07, mode="proper", alpha=1.0,
                  confmode="prod", neg_conf_loss_quantile=0.0):
    """Per-image descriptor matching loss over GT correspondences
    (MatchingLoss; withconf adds ConfMatchingLoss's weighting).
    gt_k['corres']: [B, N, 2] int (x, y); gt1['valid_corres']: [B, N]
    bool; pred_k: dense 'desc' [B,H,W,D] and 'desc_conf' [B,H,W] (or
    pointmaps with use_pts3d). -> (scalar loss, details dict)."""
    desc1 = pred1["pts3d"] if use_pts3d else pred1["desc"]
    desc2 = (pred2.get("pts3d_in_other_view", pred2.get("pts3d"))
             if use_pts3d else pred2["desc"])
    euc = bool(use_pts3d)
    xy1 = gt1["corres"].long()
    xy2 = gt2["corres"].long()
    valid = gt1["valid_corres"].bool()
    b = desc1.shape[0]
    bi = torch.arange(b, device=desc1.device)[:, None]
    d1 = desc1[bi, xy1[..., 1], xy1[..., 0]]
    d2 = desc2[bi, xy2[..., 1], xy2[..., 0]]
    per = infonce_matching_loss(d1, d2, valid_matches=valid,
                                temperature=temperature, mode=mode,
                                euc=euc, reduction="none")
    n_valid = _max(valid.sum().to(per.dtype), 1.0)
    details = dict(matching_loss=per.sum() / n_valid)
    if not withconf:
        return details["matching_loss"], details

    conf_key = "conf" if use_pts3d else "desc_conf"
    c1 = pred1[conf_key][bi, xy1[..., 1], xy1[..., 0]]
    c2 = pred2[conf_key][bi, xy2[..., 1], xy2[..., 0]]
    if confmode == "prod":
        conf = c1 * c2
    elif confmode == "mean":
        conf = 0.5 * (c1 + c2)
    else:
        raise ValueError(f"unknown confmode {confmode}")
    conf = _max(conf, 1e-8)
    cl = per * conf - alpha * torch.log(conf)
    zero = torch.zeros((), dtype=cl.dtype, device=cl.device)
    loss = torch.where(valid, cl, zero).sum() / n_valid
    if neg_conf_loss_quantile:
        # unmatched points' confidences chase the positive-loss quantile
        neg_val = torch.nanquantile(_nan_where(valid, per).reshape(-1),
                                    neg_conf_loss_quantile).detach()
        ncl = neg_val * conf - alpha * torch.log(conf)
        n_neg = _max((~valid).sum().to(cl.dtype), 1.0)
        loss = loss + torch.where(valid, zero, ncl).sum() / n_neg
    details["matching_conf_loss"] = loss
    return loss, details


def mast3r_finetune_loss(gt1, gt2, pred1, pred2, alpha=0.2,
                         match_weight=1.0, match_temperature=0.07,
                         match_alpha=1.0, **regr_kw):
    """The MASt3R fine-tuning objective: the confidence-weighted Regr3D
    term plus, when the batch carries GT correspondences, the
    confidence-weighted descriptor matching term. `alpha` weights the
    Regr3D log-conf regulariser, `match_alpha` the matching term's."""
    loss, details = regr3d_conf_loss(gt1, gt2, pred1, pred2, alpha=alpha,
                                     **regr_kw)
    if "corres" in gt1:
        ml, md = matching_loss(gt1, gt2, pred1, pred2, withconf=True,
                               alpha=match_alpha,
                               temperature=match_temperature)
        loss = loss + match_weight * ml
        details.update(md)
    return loss, details
