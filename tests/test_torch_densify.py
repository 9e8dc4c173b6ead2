"""The port's densification (models/densify.py) against the JAX package's,
on the CPU: clone, split (JAX's normals injected through `_split`),
prune, opacity reset and the gradient statistics on
tests/test_components.py's `_params` (with random rotations, moments and
per-point learning rates), carried over through convert.py. Parameters
and moments within 1e-6, per-point learning rates and N equal. Then one
port train step after a split, through the plain compositor."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.models import densify as jd
from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.models.gaussians import inverse_sigmoid as jinv
from instantsplat_tpu.opt.gaussian_opt import AdamState as JState
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.models import densify as d
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import (PARAM_FIELDS,
                                                      inverse_sigmoid)
from instantsplat_tpu_torch.opt.gaussian_opt import (GaussianOptimizer,
                                                     OptimizationConfig)
from instantsplat_tpu_torch.pipelines.trainer import train_step

torch.set_num_threads(2)


def _jax_case(n=20, seed=0):
    """tests/test_components.py's `_params`, with random rotations (the
    split turns its samples by them), moments and per-point learning
    rates, so that gathers and appends show."""
    rng = np.random.default_rng(seed)
    p = JGaussians(
        xyz=jnp.asarray(rng.standard_normal((n, 3)), jnp.float32),
        features_dc=jnp.asarray(rng.standard_normal((n, 1, 3)), jnp.float32),
        features_rest=jnp.zeros((n, 15, 3), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.01, 0.5, (n, 3))),
                            jnp.float32),
        rotation=jnp.asarray(rng.standard_normal((n, 4)), jnp.float32),
        opacity=jnp.asarray(jinv(jnp.asarray(
            rng.uniform(0.02, 0.9, (n, 1)), jnp.float32))),
        cam_poses=jnp.asarray(rng.standard_normal((2, 7)), jnp.float32),
    )

    def moments():
        return p.replace(**{f: jnp.asarray(rng.standard_normal(
            getattr(p, f).shape), jnp.float32) for f in PARAM_FIELDS})

    s = JState(m=moments(), v=moments(), step=jnp.int32(7),
               per_point_lr=jnp.asarray(rng.uniform(1, 100, (n, 1)),
                                        jnp.float32))
    return p, s


def _port(p, s):
    arrays = {f: np.asarray(getattr(p, f)) for f in PARAM_FIELDS}
    tp = convert.gaussians_from_numpy(arrays, p.max_sh_degree, device="cpu")
    ts = convert.adam_state_from_numpy(
        {f: np.asarray(getattr(s.m, f)) for f in PARAM_FIELDS},
        {f: np.asarray(getattr(s.v, f)) for f in PARAM_FIELDS},
        int(s.step), np.asarray(s.per_point_lr), device="cpu")
    return tp, ts


def _same(tp, ts, p, s):
    assert tp.num_points == p.num_points
    for f in PARAM_FIELDS:
        for a, b in ((getattr(tp, f), getattr(p, f)),
                     (ts.m[f], getattr(s.m, f)), (ts.v[f], getattr(s.v, f))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(ts.per_point_lr.numpy(),
                                  np.asarray(s.per_point_lr))
    assert ts.step == int(s.step)


def _grads(n, hot):
    g = np.zeros(n, np.float32)
    g[list(hot)] = 1.0
    return g


@pytest.mark.parametrize("extent", [100.0, 20.0])
def test_clone_matches_jax(extent):
    p, s = _jax_case()
    g = _grads(p.num_points, (3, 7, 11, 15))
    jp, js = jd.densify_and_clone(p, s, jnp.asarray(g), grad_threshold=0.5,
                                  extent=extent)
    tp, ts = d.densify_and_clone(*_port(p, s), torch.tensor(g),
                                 grad_threshold=0.5, extent=extent)
    assert tp.num_points > p.num_points or extent == 20.0
    _same(tp, ts, jp, js)


@pytest.mark.parametrize("n_split,seed", [(2, 0), (3, 4)])
def test_split_matches_jax_with_its_normals(n_split, seed):
    p, s = _jax_case(seed=1)
    g = _grads(p.num_points, (2, 5, 9))
    jp, js = jd.densify_and_split(p, s, jnp.asarray(g), grad_threshold=0.5,
                                  extent=1e-6, n_split=n_split, seed=seed)
    normals = torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (n_split, 3, 3))))
    tp, ts = d._split(*_port(p, s), torch.tensor([2, 5, 9]), normals,
                      n_split)
    assert tp.num_points == p.num_points + 3 * (n_split - 1)
    _same(tp, ts, jp, js)
    # the port's own draw: the same shapes, the originals gone
    tp2, ts2 = d.densify_and_split(*_port(p, s), torch.tensor(g),
                                   grad_threshold=0.5, extent=1e-6,
                                   n_split=n_split, seed=seed)
    assert tp2.num_points == tp.num_points
    np.testing.assert_array_equal(tp2.scaling.numpy(), tp.scaling.numpy())
    assert ts2.per_point_lr.shape == (tp.num_points, 1)


def test_prune_and_reset_match_jax():
    p, s = _jax_case(seed=2)
    jp, js = jd.prune_points(p, s, min_opacity=0.3)
    tp, ts = d.prune_points(*_port(p, s), min_opacity=0.3)
    assert tp.num_points < p.num_points
    _same(tp, ts, jp, js)
    # with radii: JAX's prune_points raises here (it ORs into the
    # read-only numpy view of a JAX array), so the port's result is held
    # to JAX's selection of the same rows
    radii = np.arange(p.num_points) % 7
    drop = ((np.asarray(p.get_opacity())[:, 0] < 0.05) | (radii > 4)
            | (np.exp(np.asarray(p.scaling)).max(-1) > 0.4))
    jp, js = jd._select(p, s, np.nonzero(~drop)[0])
    tp, ts = d.prune_points(*_port(p, s), min_opacity=0.05, extent=4.0,
                            max_screen_size=4, radii=radii)
    assert 0 < tp.num_points < p.num_points
    _same(tp, ts, jp, js)
    jr = jd.reset_opacity(p)
    tr = d.reset_opacity(_port(p, s)[0])
    np.testing.assert_allclose(tr.opacity.numpy(), np.asarray(jr.opacity),
                               rtol=0, atol=1e-6)
    assert float(torch.sigmoid(tr.opacity).max()) <= 0.01 + 1e-6
    x = np.linspace(0.01, 0.99, 50, dtype=np.float32)
    np.testing.assert_allclose(inverse_sigmoid(torch.tensor(x)).numpy(),
                               np.asarray(jinv(jnp.asarray(x))), atol=1e-6)


def test_accumulate_grad_stats_matches_jax():
    rng = np.random.default_rng(3)
    acc, den = np.zeros(50, np.float32), np.zeros(50, np.float32)
    jacc, jden = jnp.asarray(acc), jnp.asarray(den)
    tacc, tden = torch.tensor(acc), torch.tensor(den)
    for _ in range(5):
        g = rng.standard_normal((50, 2)).astype(np.float32)
        vis = rng.random(50) < 0.7
        jacc, jden = jd.accumulate_grad_stats(jacc, jden, jnp.asarray(g),
                                              jnp.asarray(vis))
        tacc, tden = d.accumulate_grad_stats(tacc, tden, torch.tensor(g),
                                             torch.tensor(vis))
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), rtol=1e-6)
    np.testing.assert_array_equal(tden.numpy(), np.asarray(jden))


def test_train_step_after_split():
    """A split changes N under the optimiser and the compositor: one train
    step then runs (plain compositor on the CPU) at the new N."""
    p, s = _jax_case(n=40, seed=4)
    tp, ts = _port(p, s)
    tp = dataclasses.replace(tp, xyz=tp.xyz * 0.3 + torch.tensor(
        [0.0, 0.0, 3.0]), cam_poses=torch.tensor(
        [[1.0, 0, 0, 0, 0, 0, 0]] * 2))
    g = torch.zeros(tp.num_points)
    g[::3] = 1.0
    tp, ts = d.densify_and_split(tp, ts, g, grad_threshold=0.5, extent=1e-6)
    assert tp.num_points == 40 + 14
    cam = Camera.create(np.eye(3), np.zeros(3), fx=20.0, fy=20.0, height=16,
                        width=24, image=np.full((16, 24, 3), 0.5,
                                                np.float32),
                        uid=1, device="cpu")
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True))
    before = tp.xyz.clone()
    out = train_step(tp, cam, opt, ts, 1, 3, torch.zeros(3), 0.2,
                     backend="pallas", chunk=256)
    assert np.isfinite(float(out["loss"]))
    assert ts.step == 8
    assert ts.m["xyz"].shape == tp.xyz.shape == (54, 3)
    assert not torch.equal(before, tp.xyz)
