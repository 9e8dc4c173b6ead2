"""The port's pre-training losses (train_dust3r/losses.py) against the
JAX package's on the CPU: the same seeded numpy inputs through both, the
value and the gradient with respect to the predictions
(`jax.value_and_grad` against autograd) within 1e-5 relative and 1e-6
absolute, for every variant of `regr3d_conf_loss`, `find_opt_scaling`,
`infonce_matching_loss`, `matching_loss` and `mast3r_finetune_loss`, and
the helpers. Medians: an even count of valid pixels pins
`torch.nanquantile(x, 0.5)` where `torch.nanmedian` (the lower middle
value) would differ from JAX.

The mixed-precision objective lives here too: one bf16 training step of
cli/pretrain.py's TINY MASt3R at 32x48 against JAX's bf16 step (finite,
float32 masters, loss within 2e-2). So does the loss's blindness to the
prediction's scale: from random weights at a high learning rate, five
steps take the pointmaps' scale past 1e30 in JAX as in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.models import mast3r as jm
from instantsplat_tpu.train_dust3r import losses as jl
from instantsplat_tpu_torch.train_dust3r import losses as tl

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
B, H, W = 2, 6, 8


def rotation(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


def make_case(seed=0, n_corres=10, nan_desc=False):
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, B, 1, 1))
    for v in range(2):
        for b in range(B):
            poses[v, b, :3, :3] = rotation(rng)
            poses[v, b, :3, 3] = rng.standard_normal(3)
    gt = []
    for v in range(2):
        pts = rng.standard_normal((B, H, W, 3)).astype(np.float32) * 2
        pts[..., 2] += 5
        valid = rng.random((B, H, W)) < 0.8
        gt.append(dict(pts3d=pts, camera_pose=poses[v], valid_mask=valid,
                       sky_mask=rng.random((B, H, W)) < 0.3))
    gt[0]["is_metric_scale"] = np.array([True, False])
    xy = np.stack([rng.integers(0, W, (B, n_corres)),
                   rng.integers(0, H, (B, n_corres))], -1).astype(np.int32)
    gt[0]["corres"] = xy
    gt[1]["corres"] = np.clip(xy + rng.integers(-1, 2, xy.shape), 0,
                              [W - 1, H - 1]).astype(np.int32)
    gt[0]["valid_corres"] = rng.random((B, n_corres)) < 0.7
    pred = []
    for v in range(2):
        desc = rng.standard_normal((B, H, W, 24)).astype(np.float32)
        desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
        if nan_desc and v == 1:
            desc[0, 0, :3] = np.nan
        p = dict(pts3d=(rng.standard_normal((B, H, W, 3)) * 2
                        + [0, 0, 5]).astype(np.float32),
                 conf=(1 + np.exp(rng.standard_normal((B, H, W)))).astype(
                     np.float32),
                 desc=desc,
                 desc_conf=(1 + np.exp(rng.standard_normal((B, H, W))))
                 .astype(np.float32))
        pred.append(p)
    pred[1]["pts3d_in_other_view"] = pred[1].pop("pts3d")
    return gt, pred


def jx(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def tt(d, grad=False):
    out = {}
    for k, v in d.items():
        t = torch.from_numpy(np.array(v))
        if grad and t.is_floating_point():
            t.requires_grad_(True)
        out[k] = t
    return out


def both(fn_j, fn_t, gt, pred):
    """(value, details, grads) of JAX's loss and of the port's, the
    gradient taken with respect to every prediction array."""
    def fj(p1, p2):
        loss, details = fn_j(jx(gt[0]), jx(gt[1]), p1, p2)
        return loss, details

    (lj, dj), gj = jax.jit(jax.value_and_grad(fj, argnums=(0, 1),
                                              has_aux=True))(
        jx(pred[0]), jx(pred[1]))
    p1, p2 = tt(pred[0], grad=True), tt(pred[1], grad=True)
    lt, dt = fn_t(tt(gt[0]), tt(gt[1]), p1, p2)
    leaves = [t for p in (p1, p2) for t in p.values()]
    gt_ = torch.autograd.grad(lt, leaves, allow_unused=True)
    gj = [gp[k] for gp, p in zip(gj, pred) for k in p]
    return (lj, dj, gj), (lt, dt, gt_)


def assert_matches(j, t, what=""):
    (lj, dj, gj), (lt, dt, gt_) = j, t
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=RTOL, atol=ATOL, err_msg=what)
    assert dj.keys() == dt.keys()
    for k in dj:
        np.testing.assert_allclose(dt[k].detach().numpy(), np.asarray(dj[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")
    for i, (a, b) in enumerate(zip(gt_, gj)):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} grad {i}")


REGR_VARIANTS = {
    "default": {},
    "no_normalize": dict(normalize=False),
    "gt_metric": dict(norm_gt=False),
    "dist_clip": dict(dist_clip=6.0),
    "shift_inv": dict(shift_inv=True),
    "scale_inv": dict(scale_inv=True),
    "scale_shift_inv": dict(shift_inv=True, scale_inv=True),
    "scale_inv_gt_metric": dict(scale_inv=True, norm_gt=False),
    "metric_scale": dict(norm_all=False),
    "metric_scale_max": dict(norm_all=False, max_metric_scale=9.0),
    "sky": dict(sky_loss_value=2.0),
    "log_before": dict(loss_in_log="before"),
    "log_both": dict(loss_in_log=True),
    "alpha": dict(alpha=0.5),
}


@pytest.mark.parametrize("name", sorted(REGR_VARIANTS))
def test_regr3d_conf_loss_variants(name):
    kw = REGR_VARIANTS[name]
    gt, pred = make_case(1)
    j, t = both(lambda *a: jl.regr3d_conf_loss(*a, **kw),
                lambda *a: tl.regr3d_conf_loss(*a, **kw), gt, pred)
    assert_matches(j, t, name)


MATCH_VARIANTS = {
    "plain": dict(),
    "withconf_prod": dict(withconf=True),
    "withconf_mean": dict(withconf=True, confmode="mean"),
    "neg_conf_quantile": dict(withconf=True, neg_conf_loss_quantile=0.5),
    "mode_all": dict(mode="all"),
    "mode_dual": dict(mode="dual", temperature=0.2),
    "pts3d_euc": dict(use_pts3d=True, withconf=True),
}


@pytest.mark.parametrize("name", sorted(MATCH_VARIANTS))
def test_matching_loss_variants(name):
    kw = MATCH_VARIANTS[name]
    gt, pred = make_case(2)
    j, t = both(lambda *a: jl.matching_loss(*a, **kw),
                lambda *a: tl.matching_loss(*a, **kw), gt, pred)
    assert_matches(j, t, name)


def test_mast3r_finetune_loss():
    gt, pred = make_case(3)
    kw = dict(match_weight=0.5, match_temperature=0.1, match_alpha=0.7,
              shift_inv=True)
    j, t = both(lambda *a: jl.mast3r_finetune_loss(*a, alpha=0.3, **kw),
                lambda *a: tl.mast3r_finetune_loss(*a, alpha=0.3, **kw),
                gt, pred)
    assert_matches(j, t)
    assert "matching_conf_loss" in t[1]


@pytest.mark.parametrize("mode", ["all", "proper", "dual"])
@pytest.mark.parametrize("euc", [False, True])
def test_infonce_modes(mode, euc):
    rng = np.random.default_rng(4)
    # unit descriptors, as the head gives them, at temperature 0.2:
    # similarities / temperature within 5. (Near-duplicate descriptors at
    # 0.1 put the logits at ~10, and the gradients' float32 rounding in
    # either package, a sum of twelve terms of ~10, reaches 1e-5.)
    d1 = rng.standard_normal((B, 12, 8)).astype(np.float32)
    d2 = (d1 + 0.3 * rng.standard_normal(d1.shape)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    valid = rng.random((B, 12)) < 0.75
    for reduction in ("mean", "none"):
        def fj(a, b):
            return jnp.sum(jl.infonce_matching_loss(
                a, b, valid, temperature=0.2, mode=mode, euc=euc,
                reduction=reduction))

        vj, gj = jax.jit(jax.value_and_grad(fj, argnums=(0, 1)))(d1, d2)
        a = torch.from_numpy(d1).requires_grad_(True)
        b = torch.from_numpy(d2).requires_grad_(True)
        vt = tl.infonce_matching_loss(a, b, torch.from_numpy(valid),
                                      temperature=0.2, mode=mode, euc=euc,
                                      reduction=reduction).sum()
        gt_ = torch.autograd.grad(vt, (a, b))
        np.testing.assert_allclose(vt.item(), float(vj), rtol=RTOL,
                                   atol=ATOL)
        for x, y in zip(gt_, gj):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                       atol=ATOL)


def test_infonce_nan_similarities():
    """A NaN descriptor makes its similarities -inf: the values agree and
    the gradients are NaN in the same places in both packages."""
    gt, pred = make_case(5, nan_desc=True)
    kw = dict(withconf=True)
    j, t = both(lambda *a: jl.matching_loss(*a, **kw),
                lambda *a: tl.matching_loss(*a, **kw), gt, pred)
    assert np.isfinite(float(j[0]))
    assert_matches(j, t, "nan descriptors")


def test_ap_matching_score():
    rng = np.random.default_rng(6)
    d1 = rng.standard_normal((B, 16, 8)).astype(np.float32)
    d2 = (d1 + 0.8 * rng.standard_normal(d1.shape)).astype(np.float32)
    d2[0, 3] = d2[0, 5]  # a tie in the scores: strict '>' ranks it below
    valid = rng.random((B, 16)) < 0.6
    for v in (None, valid):
        for euc in (False, True):
            want = float(jl.ap_matching_score(d1, d2, v, euc=euc))
            got = float(tl.ap_matching_score(
                torch.from_numpy(d1), torch.from_numpy(d2),
                None if v is None else torch.from_numpy(v), euc=euc))
            assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("fit_mode", [
    "avg", "avg_stop_grad", "median", "median_stop_grad", "weiszfeld",
    "weiszfeld_stop_grad"])
def test_find_opt_scaling(fit_mode):
    gt, pred = make_case(7)
    g1, g2 = gt[0]["pts3d"], gt[1]["pts3d"]
    v1, v2 = gt[0]["valid_mask"], gt[1]["valid_mask"]

    def fj(p1, p2):
        return jnp.sum(jl.find_opt_scaling(g1, g2, p1, p2, fit_mode, v1, v2)
                       * jnp.array([1.0, 2.0]))

    p1n, p2n = pred[0]["pts3d"], pred[1]["pts3d_in_other_view"]
    vj, gj = jax.jit(jax.value_and_grad(fj, argnums=(0, 1)))(p1n, p2n)
    p1 = torch.from_numpy(p1n).requires_grad_(True)
    p2 = torch.from_numpy(p2n).requires_grad_(True)
    s = tl.find_opt_scaling(torch.from_numpy(g1), torch.from_numpy(g2), p1,
                            p2, fit_mode, torch.from_numpy(v1),
                            torch.from_numpy(v2))
    vt = (s * torch.tensor([1.0, 2.0])).sum()
    np.testing.assert_allclose(vt.item(), float(vj), rtol=RTOL, atol=ATOL)
    if fit_mode.endswith("stop_grad"):
        assert not vt.requires_grad
        return
    for x, y in zip(torch.autograd.grad(vt, (p1, p2)), gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=ATOL)


def test_helpers_match():
    gt, pred = make_case(8)
    g1, g2 = gt[0]["pts3d"], gt[1]["pts3d"]
    v1, v2 = gt[0]["valid_mask"], gt[1]["valid_mask"]
    t = torch.from_numpy
    for a, b in zip(tl.normalize_pointcloud(t(g1), t(g2), t(v1), t(v2)),
                    jl.normalize_pointcloud(g1, g2, v1, v2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    for q in (0.5, 0.3):
        np.testing.assert_allclose(
            tl.get_joint_pointcloud_depth(t(g1[..., 2]), t(g2[..., 2]),
                                          t(v1), t(v2), q).numpy(),
            np.asarray(jl.get_joint_pointcloud_depth(
                g1[..., 2], g2[..., 2], v1, v2, q)), rtol=RTOL, atol=ATOL)
    for z_only in (False, True):
        for center in (False, True):
            for a, b in zip(
                    tl.get_joint_pointcloud_center_scale(
                        t(g1), t(g2), t(v1), t(v2), z_only, center),
                    jl.get_joint_pointcloud_center_scale(
                        g1, g2, v1, v2, z_only, center)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=RTOL, atol=ATOL)
    pose = gt[0]["camera_pose"]
    np.testing.assert_allclose(tl.se3_inv(t(pose)).numpy(),
                               np.asarray(jl.se3_inv(pose)), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tl.apply_log_to_norm(t(g1)).numpy(),
                               np.asarray(jl.apply_log_to_norm(g1)),
                               rtol=RTOL, atol=ATOL)
    mask = v1[..., None] & np.array([True, False, True])
    np.testing.assert_allclose(
        tl._masked_mean(t(g1), t(mask), axis=(1, 2)).numpy(),
        np.asarray(jl._masked_mean(g1, mask, axis=(1, 2))), rtol=RTOL,
        atol=ATOL)


def test_even_count_median_is_the_mean_of_the_middle_two():
    """Four valid values: JAX (like numpy) takes the mean of the middle
    two, torch.nanmedian the lower one; the port follows JAX."""
    z1 = np.array([[[1.0, 2.0], [3.0, 4.0]]], np.float32)
    z2 = np.full_like(z1, 100.0)
    v1 = np.ones(z1.shape, bool)
    v2 = np.zeros(z1.shape, bool)
    want = float(jl.get_joint_pointcloud_depth(z1, z2, v1, v2)[0])
    assert want == 2.5
    t = torch.from_numpy
    got = float(tl.get_joint_pointcloud_depth(t(z1), t(z2), t(v1),
                                              t(v2))[0])
    assert got == want
    lower = float(torch.nanmedian(torch.tensor([1.0, 2, 3, 4, np.nan])))
    assert lower == 2.0 != want
    # the same through the scale-invariant loss's centre and scale, and the
    # 'median' scale fit
    pts1 = np.stack([z1 * 0, z1 * 0, z1], -1)
    c_t, s_t = tl.get_joint_pointcloud_center_scale(
        t(pts1), t(pts1 + 1), t(v1), t(v2))
    c_j, s_j = jl.get_joint_pointcloud_center_scale(pts1, pts1 + 1, v1, v2)
    assert float(c_t[0, 0, 2]) == float(c_j[0, 0, 2]) == 2.5
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6)


def test_bf16_training_step_matches_jax_bf16():
    """One bf16 step of the TINY model: every parameter (LayerNorm
    included) and the images in bf16 for the forward and backward, float32
    masters and loss. The step's loss is its forward objective, so JAX's
    is read from its bf16 objective (`make_eval_step`, the same
    `_make_objective` its train step differentiates; a forward compiles in
    a fraction of a train step's time)."""
    from instantsplat_tpu.train_dust3r import trainer as jt
    from test_torch_pretrain_trainer import (FAST_COMPILE, JTINY, batch_np,
                                             port_state, rel, to_torch)

    b = batch_np(0)
    params = jm.init_params(JTINY, seed=0)
    objective = jt.make_eval_step(JTINY, loss_fn=jl.mast3r_finetune_loss,
                                  compute_dtype=jnp.bfloat16)
    jloss, _ = objective.lower(params, b).compile(
        compiler_options=FAST_COMPILE)(params, b)

    pstate, pstep = port_state(compute_dtype=torch.bfloat16)
    pstate, met = pstep(pstate, to_torch(b))
    assert all(p.dtype == torch.float32 for p in pstate["params"].values())
    assert all(m.dtype == torch.float32 for m in pstate["m"].values())
    assert met["loss"].dtype == torch.float32
    assert np.isfinite(float(met["loss"]))
    assert all(torch.isfinite(p).all() for p in pstate["params"].values())
    assert rel(met["loss"], jloss) <= 2e-2, (float(met["loss"]),
                                            float(jloss))
    # bf16 is not float32: the losses differ, by rounding only
    f32, f32_step = port_state()
    _, m32 = f32_step(f32, to_torch(b))
    assert float(met["loss"]) != float(m32["loss"])
    assert rel(met["loss"], m32["loss"]) <= 2e-2


def pointmap_scale(model, b):
    """max |pts3d| over both views of numpy batch `b`."""
    with torch.no_grad():
        r1, r2 = model(torch.from_numpy(b["img1"]),
                       torch.from_numpy(b["img2"]))
    return max(float(r1["pts3d"].abs().max()), float(r2["pts3d"].abs().max()))


def test_random_weights_pointmap_scale_drifts_alike_in_jax():
    """The scale of the random-weight model's pointmaps is free under the
    normalised Regr3D loss: Adam's steps let it drift, and expm1 of the
    head's norm makes the drift exponential while the loss falls, until
    the normalisation's sums leave float32 (ROADMAP.md §3). JAX's step
    drifts the same way: five steps at lr 3e-3 from random:0 take the
    largest |pts3d| from ~260 past 1e30 in both packages, with the same
    losses and parameters within 1e-4."""
    from instantsplat_tpu.train_dust3r import trainer as jt
    from instantsplat_tpu_torch import convert
    from instantsplat_tpu_torch.models import mast3r as tm
    from instantsplat_tpu_torch.train_dust3r import trainer as tt
    from test_torch_pretrain_trainer import (HYPER, JTINY, RTOL, TINY,
                                             assert_tree_close, batch_np,
                                             compiled, port_params_tree,
                                             rel, to_torch)

    drift = dict(HYPER, base_lr=3e-3, total_steps=8)
    micro = [batch_np(s % 4) for s in range(6)]
    init, step, _ = jt.make_dp_train_step(
        JTINY, loss_fn=jl.mast3r_finetune_loss, **drift)
    state = init(jm.init_params(JTINY, seed=0))
    step_c = compiled(step, state, micro[0])
    model = tm.build_trainable("random:0", TINY, device="cpu")
    pinit, pstep, _ = tt.make_dp_train_step(
        TINY, loss_fn=tl.mast3r_finetune_loss, **drift)
    pstate = pinit(model)
    start = pointmap_scale(model, micro[5])
    losses, loss_err = [], 0.0
    for b in micro[:5]:
        state, jmet = step_c(state, b)
        pstate, pmet = pstep(pstate, to_torch(b))
        loss_err = max(loss_err, rel(pmet["loss"], jmet["loss"]))
        losses.append(float(jmet["loss"]))
    assert loss_err <= RTOL
    assert_tree_close(port_params_tree(pstate), state["params"],
                      what="after five steps ")
    jmodel = tm.build_trainable("random:0", TINY, device="cpu")
    jmodel.load_state_dict(convert.mast3r_from_numpy(
        jax.tree_util.tree_map(np.asarray, state["params"])))
    port, jax_ = (pointmap_scale(model, micro[5]),
                  pointmap_scale(jmodel, micro[5]))
    print(f"max |pts3d| {start:.4g} -> port {port:.4g}, JAX {jax_:.4g} "
          f"(relative {rel(port, jax_):.1e}); losses {losses[0]:.4g} -> "
          f"{losses[-1]:.4g}, port against JAX <= {loss_err:.1e}")
    assert start < 1e7 and 1e30 < port < 1e38
    assert rel(port, jax_) <= 1e-3, (port, jax_)
    assert losses[-1] < 0.5 * losses[0]  # the loss fell meanwhile
