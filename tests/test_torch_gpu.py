"""Tests that need the CUDA card: the kernels K1/K2 against their plain
version, and the dense render path on the card. Run them on a machine with
a card:

    python -m pytest tests/ -m gpu -q

Whether a card is present is decided inside the `cuda` fixture, so every
worker collects the same tests; here they skip.
"""

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import rasterize_pallas as RP
from instantsplat_tpu_torch.ops.rasterize import composite_plain
from instantsplat_tpu_torch.render.driver import prepare_packed_splats, render

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scene(n, height, width, seed, device):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.6 + [0.0, 0.0, 4.0]
    g = GaussianModel.create_from_pcd(
        pts, rng.uniform(size=(n, 3)),
        cam_poses=np.array([[1.0, 0, 0, 0, 0, 0, 0]]), max_sh_degree=2,
        device=device)
    g.scaling += torch.tensor([0.4, -0.3, 0.1], device=device)
    g.opacity += torch.as_tensor(rng.normal(size=(n, 1)) * 2.0,
                                 dtype=torch.float32, device=device)
    f = 70.0 * width / 64
    cam = Camera.create(np.eye(3), np.zeros(3), fx=f, fy=f, height=height,
                        width=width, image=rng.uniform(size=(height, width,
                                                              3)),
                        device=device)
    return g, cam


@pytest.mark.parametrize("n,hw", [(400, (48, 64)), (20_000, (187, 250))])
def test_kernels_match_plain(cuda, n, hw):
    h, w = hw
    g, cam = _scene(n, h, w, 0, cuda)
    with torch.no_grad():
        packed, _ = prepare_packed_splats(g, cam.pose, cam.fx, cam.fy, cam.cx,
                                          cam.cy, 1.0, 2, h, w)
    packed = packed.contiguous()
    rng = np.random.default_rng(1)
    g_acc = torch.as_tensor(rng.normal(size=(4, h, w)), dtype=torch.float32,
                            device=cuda)
    g_t = torch.as_tensor(rng.normal(size=(h, w)), dtype=torch.float32,
                          device=cuda)
    p = packed.clone().requires_grad_(True)
    acc_p, tfin_p, lc_p = composite_plain(p, h, w)
    (grad_p,) = torch.autograd.grad((acc_p * g_acc).sum()
                                    + (tfin_p * g_t).sum(), [p])
    rect, batch = RP.splat_rects(packed, h, w)
    n1, n2 = RP.K1.launches, RP.K2.launches
    acc, tfin, lc = RP.k1_forward(packed, rect, batch, h, w)
    grad = RP.k2_backward(packed, rect, batch, g_acc,
                          (g_t * tfin).contiguous(), tfin, lc)
    torch.cuda.synchronize()
    assert (RP.K1.launches, RP.K2.launches) == (n1 + 1, n2 + 1)
    assert float((acc - acc_p.detach()).abs().max()) <= 5e-4
    assert float((tfin - tfin_p.detach()).abs().max()) <= 5e-4
    assert float((lc.long() == lc_p).float().mean()) >= 0.999
    assert float((grad - grad_p).norm() / grad_p.norm()) <= 1e-3


def test_render_on_card_matches_oracle(cuda):
    """The public render() with the dense kernels against the plain
    version on the card, image and pose gradient."""
    g, cam = _scene(400, 48, 64, 2, cuda)
    outs = {}
    for backend in ("auto", "oracle"):
        pose = cam.pose.clone().requires_grad_(True)
        o = render(g, cam, pose=pose, backend=backend)
        loss = torch.mean(torch.abs(o.render - cam.image))
        (gp,) = torch.autograd.grad(loss, [pose])
        outs[backend] = (o.render.detach(), gp)
    assert float((outs["auto"][0] - outs["oracle"][0]).abs().max()) <= 5e-4
    torch.testing.assert_close(outs["auto"][1], outs["oracle"][1], rtol=5e-3,
                               atol=1e-6)


def test_train_step_launches_both_kernels(cuda):
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    g, cam = _scene(2000, 48, 64, 3, cuda)
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True))
    state = opt.init(g)
    before = {f: getattr(g, f).clone() for f in PARAM_FIELDS}
    n1, n2 = RP.K1.launches, RP.K2.launches
    m = train_step(g, cam, opt, state, 1, 0, torch.zeros(3, device=cuda),
                   0.2, "auto", 256)
    assert (RP.K1.launches, RP.K2.launches) == (n1 + 1, n2 + 1)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before["xyz"], g.xyz)
