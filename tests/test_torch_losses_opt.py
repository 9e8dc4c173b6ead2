"""The port's loss and optimiser against the JAX package: SSIM value and
gradient (rtol 1e-5), the photometric loss, and 50 grouped / per-point
Adam steps on fixed gradients (params and moments at rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.ops import losses as jlosses
from instantsplat_tpu.ops.ssim import ssim as jax_ssim
from instantsplat_tpu.opt import gaussian_opt as jopt
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import losses, ssim
from instantsplat_tpu_torch.opt import gaussian_opt as opt

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(size=shape) * 0.1, 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(48, 64, 3), (3, 40, 30), (33, 17, 1)])
def test_ssim_value_and_grad(shape):
    a, b = _images(0, shape)
    ref_v, ref_g = jax.value_and_grad(jax_ssim)(jnp.asarray(a),
                                                 jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    v = ssim.ssim(ta, torch.tensor(b))
    (g,) = torch.autograd.grad(v, [ta])
    np.testing.assert_allclose(float(v), float(ref_v), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_g).max())


def test_photometric_loss_and_psnr():
    a, b = _images(1, (32, 48, 3))
    ref, aux = jlosses.photometric_loss(jnp.asarray(a), jnp.asarray(b), 0.2)
    got, gaux = losses.photometric_loss(torch.tensor(a), torch.tensor(b),
                                        0.2)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    for k in ("l1", "ssim"):
        np.testing.assert_allclose(float(gaux[k]), float(aux[k]), rtol=1e-5)
    np.testing.assert_allclose(
        float(losses.psnr(torch.tensor(a), torch.tensor(b))),
        float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)


def test_confidence_to_lr():
    conf = np.random.default_rng(2).normal(size=50).astype(np.float32) * 3
    np.testing.assert_allclose(opt.confidence_to_lr(conf).numpy(),
                               np.asarray(jopt.confidence_to_lr(conf)),
                               rtol=1e-6)


def _param_arrays(rng, n=200, deg=2, views=3):
    shapes = dict(xyz=(n, 3), features_dc=(n, 1, 3),
                  features_rest=(n, (deg + 1) ** 2 - 1, 3), scaling=(n, 3),
                  rotation=(n, 4), opacity=(n, 1), cam_poses=(views, 7))
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("pp,optim_pose", [(False, False), (False, True),
                                           (True, True)])
def test_adam_50_steps_match_jax(pp, optim_pose):
    rng = np.random.default_rng(3)
    params = _param_arrays(rng)
    # fixed per-step gradients; features_rest is zero throughout (the
    # whole-tensor zero-grad skip) and the pose rows of unused views are 0
    grads = []
    for _ in range(50):
        g = {k: (rng.normal(size=v.shape) * 10.0 ** rng.uniform(-4, 1)
                 ).astype(np.float32) for k, v in params.items()}
        g["features_rest"][:] = 0.0
        g["cam_poses"][1:] = 0.0
        grads.append(g)
    conf = rng.normal(size=200).astype(np.float32)
    cfg_kw = dict(pp_optimizer=pp, optim_pose=optim_pose)
    jcfg, tcfg = jopt.OptimizationConfig(**cfg_kw), opt.OptimizationConfig(
        **cfg_kw)
    conf_lr = np.asarray(jopt.confidence_to_lr(conf)) if pp else None

    jo = jopt.GaussianOptimizer(jcfg, spatial_lr_scale=2.5,
                                total_iterations=1000)
    jp = JGaussians(**{k: jnp.asarray(v) for k, v in params.items()},
                    max_sh_degree=2)
    js = jo.init(jp, confidence_lr=conf_lr)
    step = jax.jit(jo.step)
    for i, g in enumerate(grads):
        jg = JGaussians(**{k: jnp.asarray(v) for k, v in g.items()},
                        max_sh_degree=2)
        jp, js = step(jp, jg, js, jnp.int32(i + 1))

    to = opt.GaussianOptimizer(tcfg, spatial_lr_scale=2.5,
                               total_iterations=1000)
    tp = GaussianModel(**{k: torch.tensor(v) for k, v in params.items()},
                       max_sh_degree=2)
    ts = to.init(tp, confidence_lr=conf_lr)
    for i, g in enumerate(grads):
        to.step(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, i + 1)

    assert ts.step == int(js.step) == 50
    for k in PARAM_FIELDS:
        for got, ref in ((getattr(tp, k), getattr(jp, k)),
                         (ts.m[k], getattr(js.m, k)),
                         (ts.v[k], getattr(js.v, k))):
            # rtol 1e-6 of the tensor's scale: XLA contracts the update
            # into FMAs, so single steps differ in the last bit
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(),
                                       err_msg=k)
    np.testing.assert_array_equal(tp.features_rest.numpy(),
                                  params["features_rest"])
    if not optim_pose:
        np.testing.assert_array_equal(tp.cam_poses.numpy(),
                                      params["cam_poses"])
