"""Tests that need the CUDA card: the kernels KR/K1/K2 (dense), K3/K4
(binned) and K5/K6 (tiled) against their plain versions, and the render
paths on the card. Run them on a machine with a card:

    python -m pytest tests/ -m gpu -q

Whether a card is present is decided inside the `cuda` fixture, so every
worker collects the same tests; here they skip.
"""

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import rasterize_lists as RL
from instantsplat_tpu_torch.ops import rasterize_pallas as RP
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
from instantsplat_tpu_torch.ops.rasterize import composite_plain
from instantsplat_tpu_torch.render import driver
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


def _packed(n, h, w, device):
    g, cam = _scene(n, h, w, 0, device)
    with torch.no_grad():
        packed, _ = prepare_packed_splats(g, cam.pose, cam.fx, cam.fy, cam.cx,
                                          cam.cy, 1.0, 2, h, w)
    return packed.contiguous()


def _opaque_front(packed, h, w):
    """40 large, nearly opaque splats in front of the left half: every
    pixel of the tiles there hits the latched stop within a few splats."""
    rng = np.random.default_rng(8)
    front = np.zeros((40, 10), np.float32)
    front[:, 0] = rng.uniform(0, w / 2, 40)
    front[:, 1] = rng.uniform(0, h, 40)
    front[:, 2] = front[:, 4] = 1.0 / (0.2 * max(h, w)) ** 2
    front[:, 5] = np.log(0.999)
    front[:, 6:9] = rng.uniform(size=(40, 3))
    front[:, 9] = np.sort(rng.uniform(0.01, 0.02, 40))
    return torch.cat([torch.as_tensor(front, device=packed.device),
                      packed]).contiguous()


@pytest.mark.parametrize("n,hw,front", [(400, (48, 64), False),
                                        (20_000, (187, 250), False),
                                        (20_000, (187, 250), True)])
def test_rect_kernel_matches_plain(cuda, n, hw, front):
    """k1_rects against scan_plain: rectangles equal (or one rounding step
    apart on at most 0.1% of the splats), and the coarse mask exactly the
    plain mask of the kernel's own rectangles."""
    h, w = hw
    packed = _packed(n, h, w, cuda)
    if front:
        packed = _opaque_front(packed, h, w)
    n0 = RP.KR.launches
    scan = RP.k1_rects(packed, h, w)
    torch.cuda.synchronize()
    assert RP.KR.launches == n0 + 1
    plain = RP.scan_plain(packed, h, w)
    d = (scan.rect.int() - plain.rect.int()).abs()
    assert int(d.max()) <= 1
    assert int((d > 0).any(1).sum()) <= max(1, packed.shape[0] // 1000)
    assert torch.equal(scan.mask, RP.group_tile_mask(
        RP.unpack_rects(scan.rect), h, w))


def test_dense_kernels_on_a_large_image(cuda):
    """2048x1616 is 12,928 tiles: k1_rects' shared memory (4 B a tile)
    passes 48 KB and the entry point raises the kernel's limit first."""
    h, w = 1616, 2048
    packed = _packed(300, h, w, cuda)
    scan = RP.k1_rects(packed, h, w)
    torch.cuda.synchronize()
    plain = RP.scan_plain(packed, h, w)
    assert torch.equal(scan.rect, plain.rect)
    assert torch.equal(scan.mask, plain.mask)
    acc, tfin, lc = RP.k1_forward(packed, scan, h, w)
    with torch.no_grad():
        acc_p, tfin_p, lc_p = composite_plain(packed, h, w)
    assert float((acc - acc_p).abs().max()) <= 5e-4
    assert float((tfin - tfin_p).abs().max()) <= 5e-4
    assert float((lc.long() == lc_p).float().mean()) >= 0.999


@pytest.mark.parametrize("n,hw,front", [(400, (48, 64), False),
                                        (20_000, (187, 250), False),
                                        (20_000, (48, 64), False),
                                        (20_000, (187, 250), True)])
def test_kernels_match_plain(cuda, n, hw, front):
    """K1/K2 against the plain version; 20k splats at 64x48 overflow every
    tile's queue several times; with `front`, opaque splats make every
    pixel of the left tiles stop early (K1's block exit, K2's start from
    the tile's largest last contributor)."""
    h, w = hw
    packed = _packed(n, h, w, cuda)
    if front:
        packed = _opaque_front(packed, h, w)
    rng = np.random.default_rng(1)
    g_acc = torch.as_tensor(rng.normal(size=(4, h, w)), dtype=torch.float32,
                            device=cuda)
    g_t = torch.as_tensor(rng.normal(size=(h, w)), dtype=torch.float32,
                          device=cuda)
    p = packed.clone().requires_grad_(True)
    acc_p, tfin_p, lc_p = composite_plain(p, h, w)
    (grad_p,) = torch.autograd.grad((acc_p * g_acc).sum()
                                    + (tfin_p * g_t).sum(), [p])
    scan = RP.k1_rects(packed, h, w)
    n1, n2 = RP.K1.launches, RP.K2.launches
    acc, tfin, lc = RP.k1_forward(packed, scan, h, w)
    grad = RP.k2_backward(packed, scan, g_acc, (g_t * tfin).contiguous(),
                          tfin, lc)
    torch.cuda.synchronize()
    assert (RP.K1.launches, RP.K2.launches) == (n1 + 1, n2 + 1)
    assert grad.shape == (packed.shape[0], RP.NCOL)
    if front:  # most of the left 40% of the image ended at the stop
        assert float((tfin[:, :w * 2 // 5] < 2e-4).float().mean()) > 0.5
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
    before_n = (RP.KR.launches, RP.K1.launches, RP.K2.launches)
    m = train_step(g, cam, opt, state, 1, 0, torch.zeros(3, device=cuda),
                   0.2, "auto", 256)
    assert (RP.KR.launches, RP.K1.launches, RP.K2.launches) == tuple(
        c + 1 for c in before_n)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before["xyz"], g.xyz)


def _sized(kind, g, cam):
    if kind == "binned":
        caps = driver.binned_view_requirements(g, cam.pose, cam)
    else:
        caps = driver.tiled_view_requirements(g, cam.pose, cam)
    return ":".join([f"pallas-{kind}", *map(str, caps)])


def _lists(kind, packed, h, w, overflowing):
    """(lists, geometry, forward kernel, backward kernel) for capacities
    sized for these splats, or for a string that overflows."""
    cols = (packed[:, :2], packed[:, 2:5], packed[:, 5],
            RL.splat_valid(packed))
    if kind == "binned":
        caps = (1, 2) if overflowing else RB.bin_requirements(*cols, h, w)
        out = (*RB.bin_lists(packed, h, w, *caps), RB.K3, RB.K4)
    else:
        caps = (1, 1, 1) if overflowing else RT.tile_requirements(*cols, h, w)
        out = (*RT.tile_lists(packed, h, w, *caps), RT.K5, RT.K6)
    assert bool(out[0].overflow) == overflowing
    return out


@pytest.mark.parametrize("overflowing", [False, True])
@pytest.mark.parametrize("kind", ["binned", "tiled"])
@pytest.mark.parametrize("n,hw,front", [(400, (48, 64), False),
                                        (20_000, (187, 250), False),
                                        (20_000, (48, 64), False),
                                        (20_000, (187, 250), True)])
def test_list_kernels_match_plain(cuda, n, hw, front, kind, overflowing):
    """K3/K4 or K5/K6 against the plain list walk on the same lists, at a
    sized string and at an overflowing one (both drop the same pairs). 20k
    splats at 64x48 make every list several scan passes long (incomplete
    chunks wait from pass to pass); with `front`, opaque splats make every
    pixel of the left spans stop early (the forward's block exit, the
    backward's start past the span's largest last contributor)."""
    h, w = hw
    packed = _packed(n, h, w, cuda)
    if front:
        packed = _opaque_front(packed, h, w)
    lists, geom, fwd, bwd = _lists(kind, packed, h, w, overflowing)
    if (n, hw) == (20_000, (48, 64)) and not overflowing:
        assert int(lists.seg_count.max()) > 2 * 1024  # scan passes
    rect = RP.k1_rects(packed, h, w).rect
    rng = np.random.default_rng(1)
    g_acc = torch.as_tensor(rng.normal(size=(4, h, w)), dtype=torch.float32,
                            device=cuda)
    g_t = torch.as_tensor(rng.normal(size=(h, w)), dtype=torch.float32,
                          device=cuda)
    p = packed.clone().requires_grad_(True)
    acc_p, tfin_p, lc_p = RL.composite_lists_plain(p, lists, geom, h, w)
    (grad_p,) = torch.autograd.grad((acc_p * g_acc).sum()
                                    + (tfin_p * g_t).sum(), [p])
    n1, n2 = fwd.launches, bwd.launches
    acc, tfin, lc = RL.lists_forward(fwd, packed, rect, lists, geom, h, w)
    grad = RL.lists_backward(bwd, packed, rect, lists, geom, g_acc,
                             (g_t * tfin).contiguous(), tfin, lc)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (n1 + 1, n2 + 1)
    assert grad.shape == (packed.shape[0], RL.NCOL)
    if front and not overflowing:
        assert float((tfin[:, :w * 2 // 5] < 2e-4).float().mean()) > 0.5
    assert float((acc - acc_p.detach()).abs().max()) <= 5e-4
    assert float((tfin - tfin_p.detach()).abs().max()) <= 5e-4
    assert float((lc.long() == lc_p).float().mean()) >= 0.999
    assert float((grad - grad_p).norm() / grad_p.norm()) <= 1e-3


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_list_forward_is_the_same_every_launch(cuda, kind):
    """The forward kernels add nothing atomically: thirty launches on lists
    several scan passes long give bit-equal images, transmittances and last
    contributors (a race between a CTA's warps over the queue, the chunk or
    the per-warp lists would show here)."""
    h, w = 48, 64
    packed = _packed(20_000, h, w, cuda)
    lists, geom, fwd, _ = _lists(kind, packed, h, w, False)
    rect = RP.k1_rects(packed, h, w).rect
    first = RL.lists_forward(fwd, packed, rect, lists, geom, h, w)
    for _ in range(30):
        again = RL.lists_forward(fwd, packed, rect, lists, geom, h, w)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_list_kernels_take_plain_rectangles(cuda, kind):
    """The rectangles the list kernels' scan culls by are k1_rects'; handed
    the plain version's (scan_plain) instead, the kernels composite the
    same image and the same last contributors."""
    h, w = 187, 250
    packed = _packed(20_000, h, w, cuda)
    lists, geom, fwd, _ = _lists(kind, packed, h, w, False)
    plain = RP.scan_plain(packed, h, w).rect
    kernel = RP.k1_rects(packed, h, w).rect
    out_p = RL.lists_forward(fwd, packed, plain, lists, geom, h, w)
    out_k = RL.lists_forward(fwd, packed, kernel, lists, geom, h, w)
    torch.cuda.synchronize()
    for a, b in zip(out_p, out_k):
        assert torch.equal(a, b)
    # and what the scan lets through covers every pair the plain walk
    # finds: the image is the plain version's
    with torch.no_grad():
        acc_p, _, lc_p = RL.composite_lists_plain(packed, lists, geom, h, w)
    assert float((out_k[0] - acc_p).abs().max()) <= 5e-4
    assert float((out_k[2].long() == lc_p).float().mean()) >= 0.999


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_capacity_render_on_card_matches_oracle(cuda, kind):
    """The public render() with a sized capacity string on the card against
    the plain version, image and pose gradient."""
    g, cam = _scene(400, 48, 64, 2, cuda)
    outs = {}
    for backend in (_sized(kind, g, cam), "oracle"):
        pose = cam.pose.clone().requires_grad_(True)
        o = render(g, cam, pose=pose, backend=backend)
        loss = torch.mean(torch.abs(o.render - cam.image))
        (gp,) = torch.autograd.grad(loss, [pose])
        outs[backend == "oracle"] = (o.render.detach(), gp)
    assert float((outs[False][0] - outs[True][0]).abs().max()) <= 5e-4
    torch.testing.assert_close(outs[False][1], outs[True][1], rtol=5e-3,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["tiled", "binned"])
def test_train_step_launches_tiled_kernels(cuda, kind):
    """One training step with a capacity string launches the rectangle
    pass, the backend's forward and its backward kernel once each, and no
    other compositor."""
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    g, cam = _scene(2000, 48, 64, 3, cuda)
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True))
    state = opt.init(g)
    kernels = {"KR": RP.KR, "K1": RP.K1, "K2": RP.K2, "K3": RB.K3,
               "K4": RB.K4, "K5": RT.K5, "K6": RT.K6}
    mine = {"tiled": ("KR", "K5", "K6"), "binned": ("KR", "K3", "K4")}[kind]
    before = {name: k.launches for name, k in kernels.items()}
    m = train_step(g, cam, opt, state, 1, 0, torch.zeros(3, device=cuda),
                   0.2, _sized(kind, g, cam), 256)
    assert {name: k.launches - before[name] for name, k in kernels.items()
            } == {name: int(name in mine) for name in kernels}
    assert np.isfinite(float(m["loss"]))


# ---- stages 3 and 5 on the card -------------------------------------------


def test_refiner_on_card_matches_cpu(cuda):
    """Ten refinement steps through K1/K2 against the plain path on the
    CPU: the pose within the CPU test's tolerance (atol 1e-5), the loss
    within rtol 1e-5; K2 launches once a step."""
    from instantsplat_tpu_torch.pipelines.render_pipeline import (
        make_pose_refiner)
    from torch_scenes import H, W, refine_case

    arrays, M, gt, pose0 = refine_case()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        g = GaussianModel(**{f: torch.tensor(v, device=dev)
                             for f, v in arrays.items()}, max_sh_degree=1)
        cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                            width=W, image=gt, device=dev)
        before = RP.K2.launches
        pose, loss = make_pose_refiner(g, cam, num_iter=10)(pose0, cam.image)
        assert RP.K2.launches - before == (10 if dev.type == "cuda" else 0)
        out[dev.type] = (pose.cpu().numpy(), float(loss))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5)


def test_lpips_on_card_is_full_float32(cuda):
    """LPIPS on the card against the CPU within rtol 1e-4, which TF32
    convolutions would miss; the TF32 switch is left as it was found."""
    from instantsplat_tpu_torch.eval.image_metrics import LpipsVGG, lpips

    rng = np.random.default_rng(5)
    x = rng.uniform(size=(96, 128, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(size=x.shape) * 0.1, 0, 1).astype(np.float32)
    torch.backends.cudnn.allow_tf32 = True
    vals = {}
    for dev in (cuda, torch.device("cpu")):
        vals[dev.type] = float(lpips(torch.tensor(x, device=dev),
                                     torch.tensor(y, device=dev),
                                     LpipsVGG.random(0, device=dev)))
    assert torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(vals["cuda"], vals["cpu"], rtol=1e-4)


def test_render_and_metrics_on_card(cuda, tmp_path):
    """Stage 2 for a few iterations, then run_render (5 refinement steps a
    test view) and run_metrics, all on the card: the trees the JAX stages
    write, finite metrics, and K2 launched once a refinement step."""
    import json

    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.pipelines import (metrics_pipeline,
                                                  render_pipeline,
                                                  train_pipeline)
    from instantsplat_tpu_torch.pipelines.config import ModelParams
    from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig
    from torch_scenes import TEST_ANGLES, write_eval_scene

    write_eval_scene(tmp_path / "scene")
    model = ModelParams(sh_degree=2, source_path=str(tmp_path / "scene"),
                        n_views=3, model_path=str(tmp_path / "model"))
    train_pipeline.run_training(
        model, OptimizationConfig(pp_optimizer=True, optim_pose=True),
        TrainerConfig(iterations=3, backend="pallas"))
    before = RP.K2.launches
    it = render_pipeline.run_render(model, optim_test_pose_iter=5,
                                    test_fps=False)
    assert RP.K2.launches - before == 5 * len(TEST_ANGLES)
    res = metrics_pipeline.run_metrics([model.model_path],
                                       model.source_path, 3)
    vals = res[model.model_path][f"ours_{it}"]
    assert vals["LPIPS"] is None
    assert all(np.isfinite(vals[k]) for k in ("PSNR", "SSIM", "ATE",
                                              "RPE_t", "RPE_r"))
    saved = json.loads((tmp_path / "model" / "results.json").read_text())
    assert saved == res[model.model_path]
    for split, n in (("train", 3), ("test", len(TEST_ANGLES))):
        assert len(list((tmp_path / "model" / split / f"ours_{it}"
                         / "renders").glob("*.png"))) == n
