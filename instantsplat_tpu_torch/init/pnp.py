"""Pure-numpy RANSAC-PnP pose estimation (port of instantsplat_tpu/init/pnp.py;
reference: cv2.solvePnPRansac).

The equivalent of the reference's pose-completion fallback
`fast_pnp` (dust3r/cloud_opt/init_im_poses.py:259-299):
recover a camera pose from an image's fused 3D pointmap + its pixel grid
when the MST walk leaves the pose uninitialized or the dense registration
is poisoned by outliers. The reference calls cv2.solvePnPRansac(SQPNP,
reprojectionError=5, iterationsCount=10) over a geomspace(S/2, S*3, 21)
focal sweep when the focal is unknown; this module reproduces that contract
in numpy (host-side: V <= 24 images, far off the hot path — SURVEY.md §7
"host-side cv2/scipy islands").

Solver: normalized 6-point DLT for [R|t] (pixels pre-normalized by K, so
the 11-dof projective DLT reduces to the 12-parameter pose matrix up to
scale), orthonormalized via SVD with cheirality fixing, inside a RANSAC
loop scored by reprojection error; the best hypothesis is polished with
Gauss-Newton on an axis-angle parameterization over its inliers.
"""

from __future__ import annotations

import numpy as np

MIN_PNP_POINTS = 6  # DLT minimal sample (reference needs >= 4 for SQPNP)


def _rodrigues(w):
    """Axis-angle [3] -> rotation matrix."""
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R):
    """Rotation matrix -> axis-angle [3]."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * th / (2.0 * np.sin(th))


def _pose_dlt(X, xn):
    """[R|t] from >= 6 world points X [n,3] and normalized pixels xn [n,2].

    Returns (R, t) world->cam or None (degenerate sample)."""
    n = X.shape[0]
    Xh = np.hstack([X, np.ones((n, 1))])
    A = np.zeros((2 * n, 12))
    A[0::2, 0:4] = Xh
    A[0::2, 8:12] = -xn[:, 0:1] * Xh
    A[1::2, 4:8] = Xh
    A[1::2, 8:12] = -xn[:, 1:2] * Xh
    try:
        _, _, Vt = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    P = Vt[-1].reshape(3, 4)
    # fix the projective sign so the sample has positive depth
    z = Xh @ P[2]
    if np.median(z) < 0:
        P = -P
    M = P[:, :3]
    U, S, Vt2 = np.linalg.svd(M)
    if S[-1] < 1e-10 * max(S[0], 1e-30):
        return None
    d = np.sign(np.linalg.det(U @ Vt2))
    R = U @ np.diag([1.0, 1.0, d]) @ Vt2
    lam = S.mean() * d
    if abs(lam) < 1e-12:
        return None
    t = P[:, 3] / lam
    if d < 0:
        # det correction flipped the rotation's scale sign; re-check depth
        z = X @ R[2] + t[2]
        if np.median(z) < 0:
            return None
    return R, t


def _pose_planar(X, xn):
    """[R|t] from >= 4 (near-)coplanar points via plane-homography
    decomposition (Zhang). The 6-point DLT above is rank-deficient when
    the sample is coplanar — which real pointmaps (walls, floors, planar
    fixtures) hit constantly; cv2's SQPNP at the reference call site
    (init_im_poses.py:284) handles planarity natively, so RANSAC scores
    this candidate alongside the DLT one.

    Returns (R, t) world->cam or None."""
    n = X.shape[0]
    c = X.mean(0)
    X0 = X - c
    try:
        _, _, Vt = np.linalg.svd(X0, full_matrices=False)
    except np.linalg.LinAlgError:
        return None
    M = Vt.T  # plane frame: columns b1, b2, normal
    if np.linalg.det(M) < 0:
        # right-handed basis, else R = Rc @ M.T is a REFLECTION — which
        # projects coplanar points identically (planar two-fold ambiguity)
        # but breaks _log_so3/_refine_gn downstream
        M = M * np.array([1.0, 1.0, -1.0])
    v = X0 @ M  # [n,3]; v[:, 2] ~ 0 when planar
    # homography (v1, v2, 1) -> xn
    vh = np.hstack([v[:, :2], np.ones((n, 1))])
    A = np.zeros((2 * n, 9))
    A[0::2, 0:3] = vh
    A[0::2, 6:9] = -xn[:, 0:1] * vh
    A[1::2, 3:6] = vh
    A[1::2, 6:9] = -xn[:, 1:2] * vh
    try:
        _, _, Vt2 = np.linalg.svd(A)
    except np.linalg.LinAlgError:
        return None
    H = Vt2[-1].reshape(3, 3)
    n1 = np.linalg.norm(H[:, 0])
    n2 = np.linalg.norm(H[:, 1])
    if n1 < 1e-12 or n2 < 1e-12:
        return None
    H = H * (2.0 / (n1 + n2))
    for sgn in (1.0, -1.0):
        r1, r2, t = sgn * H[:, 0], sgn * H[:, 1], sgn * H[:, 2]
        Rc = np.stack([r1, r2, np.cross(r1, r2)], 1)
        U, _, Vr = np.linalg.svd(Rc)
        Rc = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vr))]) @ Vr
        R = Rc @ M.T
        tf = t - R @ c
        z = X @ R[2] + tf[2]
        if np.median(z) > 0:
            return R, tf
    return None


def _reproj_err(R, t, X, xn):
    """Per-point reprojection error in NORMALIZED image units."""
    Xc = X @ R.T + t
    z = np.where(np.abs(Xc[:, 2]) < 1e-12, 1e-12, Xc[:, 2])
    proj = Xc[:, :2] / z[:, None]
    err = np.linalg.norm(proj - xn, axis=1)
    return np.where(Xc[:, 2] <= 0, np.inf, err)  # behind camera = outlier


def _refine_gn(R, t, X, xn, iters=10):
    """Gauss-Newton on (axis-angle, t) minimizing reprojection error."""
    w = _log_so3(R)
    p = np.concatenate([w, t])
    for _ in range(iters):
        R = _rodrigues(p[:3])
        t = p[3:]
        Xc = X @ R.T + t
        z = np.maximum(Xc[:, 2], 1e-9)
        proj = Xc[:, :2] / z[:, None]
        r = (proj - xn).ravel()
        # jacobian d(proj)/d(Xc) then d(Xc)/d(w, t)
        n = X.shape[0]
        J = np.zeros((2 * n, 6))
        inv_z = 1.0 / z
        x_, y_ = Xc[:, 0] * inv_z, Xc[:, 1] * inv_z
        # d proj / d Xc  = [[1/z, 0, -x/z], [0, 1/z, -y/z]]
        # d Xc / d w     = -[Xc]_x (right-multiplied increment R <- dR R)
        # d Xc / d t     = I
        for k in range(n):
            dpdX = np.array([[inv_z[k], 0.0, -x_[k] * inv_z[k]],
                             [0.0, inv_z[k], -y_[k] * inv_z[k]]])
            Xck = Xc[k]
            dXdw = np.array([
                [0.0, Xck[2], -Xck[1]],
                [-Xck[2], 0.0, Xck[0]],
                [Xck[1], -Xck[0], 0.0],
            ])
            J[2 * k:2 * k + 2, :3] = dpdX @ dXdw
            J[2 * k:2 * k + 2, 3:] = dpdX
        JtJ = J.T @ J + 1e-9 * np.eye(6)
        try:
            dp = np.linalg.solve(JtJ, -J.T @ r)
        except np.linalg.LinAlgError:
            break
        # compose rotation increment, accumulate translation
        Rn = _rodrigues(dp[:3]) @ _rodrigues(p[:3])
        p = np.concatenate([_log_so3(Rn), p[3:] + dp[3:]])
        if np.linalg.norm(dp) < 1e-10:
            break
    return _rodrigues(p[:3]), p[3:]


def pnp_ransac(
    pts3d,
    pixels,
    K,
    niter: int = 10,
    reproj_px: float = 5.0,
    seed: int = 0,
):
    """RANSAC PnP: world->cam (R, t) + inlier mask, or None.

    Mirrors the cv2.solvePnPRansac contract at the reference call site
    (init_im_poses.py:283-284): `niter` hypothesis samples, inliers at
    `reproj_px` pixels.
    """
    pts3d = np.asarray(pts3d, np.float64).reshape(-1, 3)
    pixels = np.asarray(pixels, np.float64).reshape(-1, 2)
    n = pts3d.shape[0]
    if n < MIN_PNP_POINTS:
        return None
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    xn = (pixels - [cx, cy]) / [fx, fy]
    thr = reproj_px / float((fx + fy) / 2.0)  # px -> normalized units

    rng = np.random.default_rng(seed)
    best = (0, None, None)
    # `niter` is the reference's iterationsCount scale (cv2 samples 4-point
    # SQPNP sets; our DLT needs 6, so a clean sample is rarer) — extend
    # adaptively to 0.99 confidence given the best inlier ratio so far,
    # capped at 25x the base budget.
    it, max_it = 0, niter
    while it < max_it:
        it += 1
        if best[0] > 0:
            ratio = best[0] / n
            denom = np.log(max(1.0 - ratio**MIN_PNP_POINTS, 1e-12))
            need = int(np.ceil(np.log(0.01) / denom)) if denom < 0 else niter
            max_it = min(max(niter, need), 25 * niter)
        sel = rng.choice(n, size=MIN_PNP_POINTS, replace=False)
        # score both the general DLT pose and the planar-homography pose:
        # smooth-surface samples are often near-coplanar, where the DLT
        # is degenerate (and vice versa the homography fit is poor for
        # strongly non-planar samples — RANSAC keeps whichever scores)
        R = t = None
        score = best[0]
        for sol in (_pose_dlt(pts3d[sel], xn[sel]),
                    _pose_planar(pts3d[sel], xn[sel])):
            if sol is None:
                continue
            err_c = _reproj_err(sol[0], sol[1], pts3d, xn)
            score_c = int((err_c < thr).sum())
            if score_c > score:
                R, t, score = sol[0], sol[1], score_c
        if R is None:
            continue
        # LO-RANSAC: locally optimize every improving hypothesis on its
        # consensus set and rescore — a contaminated 6-point sample rarely
        # survives the polish, which is what lets niter stay at the
        # reference's 10 samples under heavy outlier ratios.
        inl = _reproj_err(R, t, pts3d, xn) < thr
        if inl.sum() >= MIN_PNP_POINTS:
            R2, t2 = _refine_gn(R, t, pts3d[inl], xn[inl])
            err2 = _reproj_err(R2, t2, pts3d, xn)
            if int((err2 < thr).sum()) >= score:
                R, t, score = R2, t2, int((err2 < thr).sum())
        best = (score, R, t)
    if best[0] < MIN_PNP_POINTS:
        return None
    _, R, t = best
    inl = _reproj_err(R, t, pts3d, xn) < thr
    # final polish passes, each accepted only if it keeps the consensus
    # (plain Gauss-Newton is undamped and can diverge from a poor basin)
    for _ in range(2):
        R2, t2 = _refine_gn(R, t, pts3d[inl], xn[inl])
        inl2 = _reproj_err(R2, t2, pts3d, xn) < thr
        if inl2.sum() < inl.sum():
            break
        R, t, inl = R2, t2, inl2
        if inl.sum() < MIN_PNP_POINTS:
            break
    return R, t, inl


def fast_pnp(pts3d, focal, mask, pp=None, niter_pnp: int = 10, seed: int = 0):
    """Pose (+ focal) from an image's world-frame pointmap via RANSAC-PnP.

    Numpy port of the reference's `fast_pnp` (init_im_poses.py:259-299):
    tentative focal sweep geomspace(S/2, S*3, 21) when `focal` is None,
    best hypothesis by inlier count, returns (focal, cam2world 4x4) or
    None.

    Args:
      pts3d: [H, W, 3] pointmap in WORLD frame.
      focal: known focal or None.
      mask: [H, W] bool — confident pixels.
    """
    pts3d = np.asarray(pts3d)
    mask = np.asarray(mask, bool)
    if mask.sum() < MIN_PNP_POINTS:
        return None
    H, W, _ = pts3d.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    pixels = np.stack([gx, gy], -1)

    S = max(W, H)
    focals = np.geomspace(S / 2, S * 3, 21) if focal is None else [focal]
    if pp is None:
        pp = (W / 2, H / 2)

    X = pts3d[mask]
    u = pixels[mask]
    # subsample for speed: RANSAC scoring is O(n) per hypothesis and the
    # pose is over-determined thousands of times over
    if X.shape[0] > 4096:
        idx = np.random.default_rng(seed).choice(X.shape[0], 4096,
                                                 replace=False)
        X, u = X[idx], u[idx]

    best = (0, None, None)
    for f in focals:
        K = np.array([[f, 0, pp[0]], [0, f, pp[1]], [0, 0, 1.0]])
        sol = pnp_ransac(X, u, K, niter=niter_pnp, seed=seed)
        if sol is None:
            continue
        R, t, inl = sol
        if int(inl.sum()) > best[0]:
            best = (int(inl.sum()), (R, t), float(f))
    if best[0] == 0:
        return None
    (R, t), f = best[1], best[2]
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    return f, np.linalg.inv(w2c)
