"""The port's geometry front-end against instantsplat_tpu.ops.frontend:
all 12 FrontendCols and the VJP with respect to the pose and every
Gaussian parameter, on the same seeded numpy inputs (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.ops import frontend as jfront
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.ops import frontend

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

H, W = 48, 64
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
FLOAT_COLS = ("mx", "my", "ca", "cb", "cc", "log_op", "r", "g", "b", "depth")


def _inputs(seed=0, n=300, deg=3):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [1.2, 1.0, 0.8] + [0.0, 0.0, 3.0]
    xyz[:6, 2] = [0.1, 0.19, 0.21, -1.0, 1e-9, 0.5]  # near/behind the camera
    xyz[6:10, :2] = [[30.0, 0.0], [-30.0, 1.0], [0.0, 25.0], [2.0, -25.0]]
    arrays = dict(
        xyz=xyz,
        features_dc=rng.normal(size=(n, 1, 3)) * 0.8,
        features_rest=rng.normal(size=(n, (deg + 1) ** 2 - 1, 3)) * 0.3,
        scaling=rng.normal(size=(n, 3)) * 0.5 - 2.5,
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)) * 2.0,
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    q = rng.normal(size=4) * [0.05, 0.05, 0.05, 0.05] + [1.0, 0, 0, 0]
    pose = np.concatenate([q, rng.normal(size=3) * 0.1]).astype(np.float32)
    return arrays, pose


def _jax_cols(arrays, pose, deg, active):
    g = JGaussians(**{k: jnp.asarray(v) for k, v in arrays.items()},
                   cam_poses=jnp.zeros((0, 7)), max_sh_degree=deg)
    return jfront.compute_columns(
        g, jnp.asarray(pose), jnp.float32(60.0), jnp.float32(58.0),
        jnp.float32((W - 1) / 2), jnp.float32((H - 1) / 2), jnp.float32(1.0),
        active, H, W)


def _torch_cols(tensors, pose_t, deg, active):
    g = GaussianModel(**tensors, cam_poses=torch.zeros((0, 7)),
                      max_sh_degree=deg)
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    return frontend.compute_columns(
        g, pose_t, f32(60.0), f32(58.0), f32((W - 1) / 2), f32((H - 1) / 2),
        1.0, active, H, W)


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_columns_match_jax(active):
    arrays, pose = _inputs(seed=active)
    ref = _jax_cols(arrays, pose, 3, active)
    got = _torch_cols({k: torch.tensor(v) for k, v in arrays.items()},
                      torch.tensor(pose), 3, active)
    valid = np.asarray(ref.valid)
    assert 0 < valid.sum() < len(valid)  # both culled and kept splats
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in FLOAT_COLS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        # compare where the JAX value is finite-sized; culled rows included
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(
            b).max(), err_msg=name)


@pytest.mark.parametrize("active", [1, 3])
def test_vjp_matches_jax(active):
    arrays, pose = _inputs(seed=10 + active)
    rng = np.random.default_rng(99)
    cot = {c: rng.normal(size=len(arrays["xyz"])).astype(np.float32)
           for c in FLOAT_COLS}

    def jloss(params, p):
        cols = _jax_cols(params, p, 3, active)
        return sum(jnp.sum(getattr(cols, c) * cot[c]) for c in FLOAT_COLS)

    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    jg, jp = jax.grad(jloss, argnums=(0, 1))(jarr, jnp.asarray(pose))

    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in arrays.items()}
    pose_t = torch.tensor(pose, requires_grad=True)
    cols = _torch_cols(tensors, pose_t, 3, active)
    loss = sum(torch.sum(getattr(cols, c) * torch.tensor(cot[c]))
               for c in FLOAT_COLS)
    grads = torch.autograd.grad(loss, [pose_t] + [tensors[k] for k in FIELDS])
    # relative to each gradient's scale: sums of cancelling terms make some
    # entries small against the rest
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jp)).max())
    for k, g in zip(FIELDS, grads[1:]):
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=k)
