"""Tests that need the CUDA card: the kernels KR/K1/K2 (dense), K3/K4
(binned) and K5/K6 (tiled) against their plain versions, the KNN kernel
knn3 against its plain version and a float64 brute force, the front
end's kernels against compute_columns and autograd, the render
paths on the card, stage 1's TINY MASt3R and golden aligner case on the
card against the CPU, init_test_pose on the card against the CPU, a
live viewer render on the card, and the sparse-alignment family:
matching and sparse alignment on the card against the CPU, a
densification followed by a dense train step on the card, and
cli.pretrain's TINY training step (float32 card against CPU, bf16, a
checkpoint round trip), and the captured training blocks
(make_train_scan): replays against eager steps, no host sync in a
replayed block, a step with a host read failing its capture, and the
traced step, whose graph differs by its device marks alone. Run them on
a machine with a card:

    python -m pytest tests/ -m gpu -q

Whether a card is present is decided inside the `cuda` fixture, so every
worker collects the same tests; here they skip.
"""

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import frontend as FE
from instantsplat_tpu_torch.ops import knn as KNN
from instantsplat_tpu_torch.ops import rasterize_lists as RL
from instantsplat_tpu_torch.ops import rasterize_pallas as RP
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
from instantsplat_tpu_torch.ops.rasterize import composite_plain
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import prepare_packed_splats, render
from torch_frontend_cases import frontend_scene, packed_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # full float32, as the package sets on import: a test may have
    # switched cuDNN's TF32 back on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _knn_cloud(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "clustered":  # 40 tight clusters; a tenth of the points
        # copies of others (0-distance neighbours), some copied twice
        centres = rng.normal(size=(40, 3))
        pts = (centres[rng.integers(0, 40, n)]
               + rng.normal(size=(n, 3)) * 0.01)
        src = rng.choice(n, n // 10, replace=False)
        dst = rng.choice(np.setdiff1d(np.arange(n), src), n // 10,
                         replace=False)
        pts[dst] = pts[src]
        pts[dst[:n // 40]] = pts[src[-(n // 40):]]
    else:  # "normal" near the origin, "far": centred 1e3 from it
        pts = rng.normal(size=(n, 3)) * 0.5 + (
            [1.0, -2.0, 3.0] if kind == "normal" else 1e3)
    return pts.astype(np.float32)


def _knn_brute_force(pts):
    """float64 mean of the 3 smallest squared distances to other points,
    over every pair, of the cloud centred in float32 as mean_knn_dist2
    centres it."""
    p = (pts - pts.mean(dim=0, keepdim=True)).double()
    out = []
    for s in range(0, p.shape[0], 1024):
        d2 = ((p[s:s + 1024, None, :] - p[None]) ** 2).sum(-1)
        rows = torch.arange(d2.shape[0], device=p.device)
        d2[rows, rows + s] = float("inf")
        out.append(torch.topk(d2, 3, dim=1, largest=False).values.mean(1))
    return torch.clamp(torch.cat(out), min=1e-7)


@pytest.mark.parametrize("kind,n", [("normal", 700), ("normal", 1500),
                                    ("normal", 4), ("clustered", 20_000),
                                    ("far", 1500)])
def test_knn_kernel_matches_plain_and_brute_force(cuda, kind, n):
    """knn3 in one launch, against the plain version (chunked cdist + topk
    + the exact pass) at rtol 1e-6 and a float64 search over every pair at
    rtol 1e-5; the same bits on a second call."""
    pts = torch.as_tensor(_knn_cloud(kind, n, n), device=cuda)
    before = KNN.KNN3.launches
    got = KNN.mean_knn_dist2(pts)
    assert KNN.KNN3.launches == before + 1
    torch.testing.assert_close(got, KNN.mean_knn_dist2_plain(pts),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(got.double(), _knn_brute_force(pts),
                               rtol=1e-5, atol=0)
    assert torch.equal(KNN.mean_knn_dist2(pts), got)


def test_knn_on_pinned_host_memory_takes_the_plain_version(cuda):
    pts = torch.as_tensor(_knn_cloud("normal", 700, 7)).pin_memory()
    before = KNN.KNN3.launches
    got = KNN.mean_knn_dist2(pts)
    assert KNN.KNN3.launches == before and got.device.type == "cpu"
    torch.testing.assert_close(got, KNN.mean_knn_dist2_plain(pts), rtol=0,
                               atol=0)


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


def test_mast3r_tiny_on_card(cuda):
    """The TINY MASt3R with tests/test_mast3r.py's synthetic state dict:
    every pair through infer_pairs on the card against the CPU, float32
    (TF32 off) within 1e-5 of the largest magnitude; bf16 on the card
    under tests/test_mast3r.py's law."""
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.models.mast3r_infer import infer_pairs
    from torch_init_cases import TINY, fake_upstream_sd

    sd = fake_upstream_sd(TINY)
    rng = np.random.default_rng(5)
    imgs = rng.random((3, 32, 48, 3)).astype(np.float32)
    pairs = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = mast3r.load_upstream_state_dict(
            mast3r.MASt3R(TINY).to(dev).eval(), sd)
        out[dev.type] = infer_pairs(model, imgs, pairs, batch_size=4)
    for k in ("pred_i", "pred_j", "conf_i", "conf_j", "desc_i", "desc_j"):
        a, b = getattr(out["cuda"], k), getattr(out["cpu"], k)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
        assert err <= 1e-5, (k, err)
    model16 = mast3r.load_upstream_state_dict(
        mast3r.MASt3R(TINY).to(cuda).eval(), sd).cast(torch.bfloat16)
    p16 = infer_pairs(model16, imgs, pairs, batch_size=4)
    d = np.abs(p16.pred_i - out["cpu"].pred_i) / np.abs(
        out["cpu"].pred_i).max()
    assert np.quantile(d, 0.999) < 0.05 and d.max() < 0.5


def test_aligner_golden_case_on_card(cuda):
    """The golden aligner case on the card: tests/test_golden.py's
    tolerances against tests/golden/aligner_case.npz and against the CPU
    (the gathers' backward adds with atomics on the card)."""
    from pathlib import Path

    from torch_init_cases import run_aligner_case

    golden = np.load(Path(__file__).parent / "golden" / "aligner_case.npz")
    got = run_aligner_case(cuda)
    ref = run_aligner_case("cpu")
    for want in (golden, ref):
        np.testing.assert_allclose(got["poses"], want["poses"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_init_test_pose_on_card(cuda, tmp_path):
    """The oracle run_init_test_pose (15 images, 210 pairs at 48x64, 30
    aligner iterations) on the card against the CPU: the transported test
    poses within 1e-4 (the aligner's gathers add with atomics on the
    card)."""
    from instantsplat_tpu_torch.init.aligner import PairPrediction
    from instantsplat_tpu_torch.pipelines.init_test_pose_pipeline import (
        run_init_test_pose)
    from torch_init_cases import oracle_pointmap_fn, write_stage1_cloud

    out = {}
    for dev in (cuda, torch.device("cpu")):
        root = tmp_path / dev.type
        files = write_stage1_cloud(root)
        out[dev.type] = run_init_test_pose(
            root, tmp_path / f"{dev.type}_out",
            oracle_pointmap_fn(files, PairPrediction, with_test=True),
            image_size=64, niter=30, device=dev)
    assert out["cuda"].shape == (12, 4, 4)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-4)


def test_viewer_render_on_card(cuda, tmp_path):
    """train_joint on the card answers one loopback viewer request before
    its first step: the image is render() of the same camera and params
    within 1/255, rendered by the dense kernels."""
    import socket
    import threading

    from instantsplat_tpu_torch.convert import gaussians_from_numpy, to_numpy
    from instantsplat_tpu_torch.data.scene import read_scene
    from instantsplat_tpu_torch.models.camera import fov2focal
    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.pipelines.trainer import (TrainerConfig,
                                                          train_joint)
    from instantsplat_tpu_torch.render.network_gui import NetworkGUI
    from torch_scenes import (receive_image, send_view_request,
                              write_tiny_scene)

    write_tiny_scene(tmp_path / "scene")
    info = read_scene(tmp_path / "scene", 3, device=cuda)
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=2, device=cuda,
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    arrays = to_numpy(g)
    h, w = 48, 64
    gui = NetworkGUI()
    gui.init("127.0.0.1", 0)
    conn = socket.create_connection(
        ("127.0.0.1", gui.listener.getsockname()[1]), timeout=60)
    send_view_request(conn, h, w, info.poses_w2c[2])
    got = {}

    def receive():
        got["img"], _ = receive_image(conn, h, w)
        conn.close()

    t = threading.Thread(target=receive)
    t.start()
    before = RP.K1.launches
    try:
        train_joint(gaussians_from_numpy(arrays, 2, device=cuda),
                    info.cameras, OptimizationConfig(), TrainerConfig(
                        iterations=2, backend="pallas", log_every=1),
                    spatial_lr_scale=info.nerf_radius, viewer=gui)
    finally:
        t.join(timeout=60)
        gui.close()
    assert not t.is_alive()
    assert RP.K1.launches - before == 3  # two steps and the viewer's render
    w2c = info.poses_w2c[2]
    cam = Camera.create(w2c[:3, :3], w2c[:3, 3], fx=fov2focal(1.0, w),
                        fy=fov2focal(0.8, h), height=h, width=w, device=cuda)
    with torch.no_grad():
        want = render(gaussians_from_numpy(arrays, 2, device=cuda), cam,
                      backend="pallas").render.cpu().numpy()
    assert np.abs(got["img"] / 255.0 - want).max() <= 1 / 255


def test_matching_on_card_matches_cpu(cuda):
    """Integer descriptors (a shifted copy with integer noise): every
    distance is exact in float32 whatever the summation order, so the card
    and the CPU must find the same matches. (Real-valued descriptors at a
    near-tie may flip: cuBLAS and the CPU's GEMM round differently.)"""
    from instantsplat_tpu_torch.ops.matching import fast_reciprocal_nns

    rng = np.random.default_rng(0)
    d1 = np.round(rng.standard_normal((96, 128, 24)) * 50).astype(np.float32)
    d2 = np.roll(d1, (-2, -3), axis=(0, 1)) + rng.integers(
        -5, 6, d1.shape).astype(np.float32)
    for subsample in (4, 8):
        got = fast_reciprocal_nns(d1, d2, subsample=subsample, chunk=512,
                                  device=cuda)
        ref = fast_reciprocal_nns(d1, d2, subsample=subsample, chunk=512,
                                  device="cpu")
        assert len(ref[0]) > 100
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_sparse_alignment_on_card_matches_cpu(cuda):
    """30 + 30 iterations: the gathers' backward adds with atomics on the
    card, so the two differ by rounding (1e-3, as stage 1's aligner)."""
    from instantsplat_tpu_torch.init.aligner import PairPrediction
    from instantsplat_tpu_torch.init.sparse_align import (
        extract_matches, sparse_global_alignment)
    from torch_init_cases import attach_world_desc, sparse_scene

    c2w, _, preds = sparse_scene(PairPrediction, n_views=3)
    attach_world_desc(preds, c2w)
    matches = extract_matches(preds, subsample=4, device="cpu")
    res = {dev: sparse_global_alignment(preds, matches=matches, subsample=4,
                                        niter1=30, niter2=30, device=dev)
           for dev in (cuda, "cpu")}
    np.testing.assert_allclose(res[cuda].c2w, res["cpu"].c2w, atol=1e-3)
    np.testing.assert_allclose(res[cuda].focals, res["cpu"].focals,
                               rtol=1e-3)
    np.testing.assert_allclose(res[cuda].loss, res["cpu"].loss, rtol=1e-3)


def test_densify_then_train_step_on_card(cuda):
    from instantsplat_tpu_torch.models import densify
    from instantsplat_tpu_torch.opt.gaussian_opt import (GaussianOptimizer,
                                                         OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    g, cam = _scene(2000, 48, 64, 3, cuda)
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True))
    state = opt.init(g)
    grads = torch.zeros(g.num_points, device=cuda)
    grads[::4] = 1.0
    g, state = densify.densify_and_clone(g, state, grads, 0.5, extent=1e3)
    g, state = densify.densify_and_split(g, state, torch.cat(
        [grads, grads[:500]]), 0.5, extent=1e-3)
    assert g.num_points == 2000 + 500 + 625
    assert state.per_point_lr.shape == (g.num_points, 1)
    before = (RP.K1.launches, RP.K2.launches)
    out = train_step(g, cam, opt, state, 1, 2, torch.zeros(3, device=cuda),
                     0.2, backend="pallas", chunk=256)
    assert np.isfinite(float(out["loss"]))
    assert (RP.K1.launches, RP.K2.launches) == (before[0] + 1,
                                                before[1] + 1)


def _pretrain_batch(seed):
    """cli.pretrain's TINY model's input at 32x48: trainer.synthetic_batch
    plus seeded GT correspondences (the MASt3R fine-tuning loss)."""
    from instantsplat_tpu_torch.train_dust3r.trainer import synthetic_batch

    b = synthetic_batch(None, batch=2, h=32, w=48, seed=seed)
    rng = np.random.default_rng(100 + seed)
    xy = np.stack([rng.integers(0, 48, (2, 24)),
                   rng.integers(0, 32, (2, 24))], -1).astype(np.int32)
    b["gt1"]["corres"] = torch.from_numpy(xy)
    b["gt2"]["corres"] = torch.from_numpy(np.clip(
        xy + rng.integers(-2, 3, xy.shape), 0, [47, 31]).astype(np.int32))
    b["gt1"]["valid_corres"] = torch.from_numpy(rng.random((2, 24)) < 0.8)
    return b


def _pretrain_steps(device, n, compute_dtype=None, accum_iter=1):
    from instantsplat_tpu_torch.cli.pretrain import TINY
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.train_dust3r import losses, trainer

    cfg = mast3r.MASt3RConfig(**TINY)
    model = mast3r.build_trainable("random:0", cfg, device=device)
    init, step, _ = trainer.make_dp_train_step(
        cfg, loss_fn=losses.mast3r_finetune_loss, base_lr=5e-4,
        warmup_steps=1, total_steps=4, compute_dtype=compute_dtype,
        accum_iter=accum_iter)
    state = init(model)
    losses_ = []
    for s in range(n):
        state, met = step(state, _pretrain_batch(s))
        losses_.append(float(met["loss"]))
    return state, losses_


def test_pretrain_tiny_step_on_card_matches_cpu(cuda):
    """Three float32 steps of cli.pretrain's TINY model (TF32 off) on the
    card against the CPU: losses within 1e-4 relative, every parameter
    within 1e-3 relative L2. Not 1e-4: the key biases' gradients are
    ~1e-6, so their summation order (cuBLAS against oneDNN) moves their
    Adam steps by a visible share (2.1e-4 relative L2 on an H100 after
    three steps; ROADMAP.md §3, Adam amplifies rounding)."""
    card, lc = _pretrain_steps(cuda, 3)
    cpu, lp = _pretrain_steps("cpu", 3)
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    for k, p in cpu["params"].items():
        q = card["params"][k].detach().cpu()
        err = float(torch.linalg.norm(q - p.detach())) / max(
            float(torch.linalg.norm(p.detach())), 1e-6)
        assert err <= 1e-3, (k, err)


def test_pretrain_bf16_step_on_card(cuda):
    """bf16 steps on the card: finite, float32 masters and moments, the
    loss within 2e-2 of the float32 step's."""
    state, l16 = _pretrain_steps(cuda, 2, compute_dtype=torch.bfloat16,
                                 accum_iter=1)
    _, l32 = _pretrain_steps(cuda, 2)
    assert np.isfinite(l16).all()
    assert all(p.dtype == torch.float32 and p.is_cuda
               for p in state["params"].values())
    assert all(m.dtype == torch.float32 for m in state["v"].values())
    np.testing.assert_allclose(l16, l32, rtol=2e-2)


def test_pretrain_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A checkpoint written from the card resumes on the card and on the
    CPU with every tensor equal, and the step."""
    from instantsplat_tpu_torch.cli.pretrain import TINY
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.train_dust3r import trainer

    state, _ = _pretrain_steps(cuda, 2)
    path = tmp_path / "checkpoint-last.npz"
    trainer.save_pretrain_checkpoint(path, state)
    cfg = mast3r.MASt3RConfig(**TINY)
    for dev in (cuda, torch.device("cpu")):
        init, _, _ = trainer.make_dp_train_step(cfg)
        back = trainer.load_pretrain_checkpoint(
            path, init(mast3r.build_trainable("random:1", cfg, device=dev)))
        assert back["step"] == 2
        for group in ("params", "m", "v"):
            for k, t in state[group].items():
                assert back[group][k].device.type == dev.type
                torch.testing.assert_close(back[group][k].cpu(),
                                           t.detach().cpu(), rtol=0, atol=0)


@pytest.fixture
def nccl_one_rank(cuda, tmp_path):
    """A one-rank NCCL group in this process (FileStore rendezvous), torn
    down after the test."""
    import torch.distributed as dist

    from instantsplat_tpu_torch.parallel import initialize_runtime

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    initialize_runtime("cuda", init_method=f"file://{tmp_path / 'store'}",
                       world_size=1, rank=0)
    assert dist.get_backend() == "nccl"
    yield cuda
    dist.destroy_process_group()


def test_sharded_renders_on_one_nccl_rank(nccl_one_rank):
    """sharded_render (dense and binned rows), gaussian_sharded_render and
    the hybrid render on a one-rank NCCL mesh: KR/K1/K2 and K3/K4 through
    the collectives, image and gradients equal to the one-device render."""
    from instantsplat_tpu_torch.ops.losses import photometric_loss
    from instantsplat_tpu_torch.parallel import (gaussian_sharded_render,
                                                 hybrid_sharded_render,
                                                 make_mesh, make_mesh_nd,
                                                 sharded_render)

    dev = nccl_one_rank
    g, cam = _scene(3000, 96, 128, 5, dev)
    mesh, mesh2 = make_mesh(1), make_mesh_nd((1, 1), ("pix", "gauss"))

    def grads(fn):
        for t in g.tensors():
            t.requires_grad_(True)
        rgb = fn(g.get_pose(0))
        out = torch.autograd.grad(photometric_loss(rgb, cam.image)[0],
                                  [g.xyz, g.cam_poses])
        for t in g.tensors():
            t.requires_grad_(False)
        return rgb.detach(), out

    ref, ref_g = grads(lambda pose: render(g, cam, pose=pose,
                                           backend="pallas").render)
    for fn in (
            lambda pose: sharded_render(g, cam, mesh, pose=pose,
                                        backend="pallas")[0],
            lambda pose: sharded_render(g, cam, mesh, pose=pose,
                                        backend="pallas-binned:8:32")[0],
            lambda pose: gaussian_sharded_render(g, cam, mesh, pose=pose)[0],
            lambda pose: hybrid_sharded_render(g, cam, mesh2,
                                               pose=pose)[0]):
        rgb, gr = grads(fn)
        torch.testing.assert_close(rgb, ref, rtol=0, atol=5e-4)
        for a, b in zip(gr, ref_g):
            rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            assert rel <= 1e-3, rel


def test_train_joint_on_one_nccl_rank(nccl_one_rank):
    """train_joint(mesh=) over one NCCL rank follows the one-device loss
    curve (K2's atomics: 1e-3 relative over 10 iterations)."""
    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.parallel import make_mesh
    from instantsplat_tpu_torch.pipelines.trainer import (TrainerConfig,
                                                          train_joint)

    dev = nccl_one_rank
    curves = []
    for mesh in (None, make_mesh(1)):
        g, cam = _scene(2000, 64, 96, 9, dev)
        _, _, hist = train_joint(
            g, [cam], opt_cfg=OptimizationConfig(optim_pose=True),
            trainer_cfg=TrainerConfig(iterations=10, backend="pallas",
                                      log_every=1), mesh=mesh)
        curves.append(np.array([m["loss"] for _, m in hist]))
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-3)


# ---- device-resident loops: captured CUDA graphs ---------------------------


def _scan_case(cuda, total=50):
    """Gaussians, one view stacked, the optimizer, a fresh state and a
    snapshot/restore pair that writes a state back into the SAME tensors
    (a captured graph reads their storage)."""
    from instantsplat_tpu_torch.models.camera import stack_cameras
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)

    g, cam = _scene(2000, 48, 64, 3, cuda)
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True),
                            total_iterations=total)
    state = opt.init(g)

    def snapshot():
        return ({f: getattr(g, f).clone() for f in PARAM_FIELDS},
                {f: state.m[f].clone() for f in PARAM_FIELDS},
                {f: state.v[f].clone() for f in PARAM_FIELDS}, state.step)

    def restore(snap):
        p, m, v, step = snap
        for f in PARAM_FIELDS:
            getattr(g, f).copy_(p[f])
            state.m[f].copy_(m[f])
            state.v[f].copy_(v[f])
        state.step = step

    return g, cam, stack_cameras([cam]), opt, state, snapshot, restore


def _eager_steps(g, cam, opt, state, iters):
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    for i in iters:
        train_step(g, cam, opt, state, i, 0, torch.zeros(3,
                                                         device=g.xyz.device),
                   0.2, "pallas", 256)


def _rel_l2(a, b):
    """Relative L2 by field (absolute where b is all zero)."""
    return {f: float(torch.linalg.norm((a[f] - b[f]).double()))
            / (float(torch.linalg.norm(b[f].double())) or 1.0)
            for f in PARAM_FIELDS}


@pytest.mark.parametrize("k", [1, 8])
def test_captured_block_matches_eager(cuda, k):
    """From one state: a block of k replays of the captured step (k = 8:
    every step has its own learning rate and bias corrections, which a
    scalar frozen at capture would get wrong) against k eager steps,
    within twice the spread of two eager runs (K2 adds with atomics) plus
    1e-6, by relative L2 (Adam moves a parameter whose gradient sits at
    the rounding floor by +-lr, whichever way the atomics round it)."""
    from instantsplat_tpu_torch.pipelines.trainer import make_train_scan
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    g, cam, stacked, opt, state, snapshot, restore = _scan_case(cuda)
    s0 = snapshot()
    block = make_train_scan(opt, stacked, torch.zeros(3, device=cuda), 0.2,
                            "pallas", 256)
    block(g, state, [0] * (WARMUP + 1), range(1, WARMUP + 2), 0)  # capture
    restore(s0)
    replays = StepLoop.replays
    _, _, metrics = block(g, state, [0] * k, range(1, k + 1), 0)
    assert StepLoop.replays - replays == k and state.step == k
    assert np.isfinite(float(metrics["loss"]))
    captured = snapshot()[0]
    eager = []
    for _ in range(2):
        restore(s0)
        _eager_steps(g, cam, opt, state, range(1, k + 1))
        eager.append(snapshot()[0])
    spread = _rel_l2(eager[1], eager[0])
    got = _rel_l2(captured, eager[0])
    for f in PARAM_FIELDS:
        assert got[f] <= 2 * spread[f] + 1e-6, (f, got[f], spread[f])


def test_replay_makes_no_host_sync(cuda):
    """A block of replays under torch.cuda.set_sync_debug_mode("error"):
    nothing between the block's start and its end reads the device."""
    from instantsplat_tpu_torch.pipelines.trainer import make_train_scan
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP

    g, cam, stacked, opt, state, _, _ = _scan_case(cuda)
    block = make_train_scan(opt, stacked, torch.zeros(3, device=cuda), 0.2,
                            "pallas", 256)
    block(g, state, [0] * (WARMUP + 1), range(1, WARMUP + 2), 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, metrics = block(g, state, [0] * 6, range(WARMUP + 2,
                                                      WARMUP + 8), 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(metrics["loss"]))


def test_host_read_in_a_step_makes_capture_raise(cuda, monkeypatch):
    """A step that reads a device value on the host runs eagerly in the
    warm-up but cannot be captured: the block raises, naming the loop,
    and does not go on eagerly."""
    from instantsplat_tpu_torch.pipelines import trainer as tr
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP

    g, cam, stacked, opt, state, _, _ = _scan_case(cuda)
    real = tr.psnr
    monkeypatch.setattr(tr, "psnr", lambda a, b: real(a, b).new_full(
        (), float(real(a, b))))
    block = tr.make_train_scan(opt, stacked, torch.zeros(3, device=cuda),
                               0.2, "pallas", 256)
    with pytest.raises(RuntimeError, match="make_train_scan"):
        block(g, state, [0] * (WARMUP + 2), range(1, WARMUP + 3), 0)


def test_trace_marks_are_the_only_difference(cuda, tmp_path, monkeypatch):
    """Tracing on (utils/profiling.enable) changes the captured step by its
    marks alone: one replay's kernels in a torch.profiler trace number
    exactly len(STEP_MARKS) more than with tracing off, and the launches
    a replay makes (StepLoop.per_replay) are the same but for trace_mark's
    len(STEP_MARKS). One capture each. The untraced graph compared is
    the second one captured: the first of a process carried 80 kernels
    more on the card (H100, PyTorch 2.11), traced or not. A traced
    block's phases and gaps sum to its CUDA-event time (events around the
    block call; the block's own mark is launched as it starts) within
    3%."""
    import json

    from instantsplat_tpu_torch.pipelines.trainer import (STEP_MARKS,
                                                          make_train_scan)
    from instantsplat_tpu_torch.utils import profiling
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    g, cam, stacked, opt, state, _, _ = _scan_case(cuda, total=300)
    bg = torch.zeros(3, device=cuda)
    loops = []
    real = StepLoop._capture
    monkeypatch.setattr(StepLoop, "_capture",
                        lambda self: (loops.append(self), real(self))[1])
    kernels, per_replay, blocks, it = {}, {}, {}, 1
    try:
        for traced in (False, True, False):
            profiling.reset()
            profiling.enable(traced)
            block = blocks[traced] = make_train_scan(opt, stacked, bg, 0.2,
                                                     "pallas", 256)
            block(g, state, [0] * (WARMUP + 1), range(it, it + WARMUP + 1), 0)
            it += WARMUP + 1
            assert profiling.snapshot()["counters"]["steploop.captures"] == 1
            loop = loops[-1]
            per_replay[traced] = {k.name: n
                                  for k, n in loop.per_replay.items()}
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                loop.graph.replay()
                torch.cuda.synchronize()
            path = tmp_path / f"replay{int(traced)}.json"
            prof.export_chrome_trace(str(path))
            kernels[traced] = sorted(
                e["name"] for e in json.loads(path.read_text())[
                    "traceEvents"] if e.get("cat") == "kernel")
        marks = [n for n in kernels[True] if "trace_mark" in n]
        rest = [n for n in kernels[True] if "trace_mark" not in n]
        assert (len(kernels[False]), len(marks)) == (
            len(rest), len(STEP_MARKS)), (len(kernels[False]), len(rest),
                                          len(marks))
        assert rest == kernels[False]
        assert per_replay[True].pop("trace_mark") == len(STEP_MARKS)
        assert per_replay[True] == per_replay[False]
        k = 100
        profiling.enable(True)  # the traced graph again
        profiling.reset()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda.synchronize()
        start.record()
        blocks[True](g, state, [0] * k, range(it, it + k), 0)
        end.record()
        torch.cuda.synchronize()
        snap = profiling.snapshot()
        assert "steploop.capture" not in snap["spans"]
        phases = snap["phases"]["make_train_scan"]["pallas"]
        assert {n: p["steps"] for n, p in phases.items()} == dict.fromkeys(
            ("frontend", "raster", "loss", "adam", "replay_gap"), k)
        assert all(p["seconds"] > 0 for p in phases.values()), phases
        total = sum(p["seconds"] for p in phases.values())
        wall = start.elapsed_time(end) * 1e-3
        assert total == pytest.approx(wall, rel=0.03), (phases, wall)
    finally:
        profiling.enable(False)
        profiling.reset()


# ---- the front end: csrc/frontend.cu against compute_columns -------------


def _fe_leaves(g, pose):
    return [getattr(g, f) for f in FE.FIELDS] + [pose]


def _fe_close(got, want, what):
    """Within 1e-4 of the field's largest plain magnitude, elementwise."""
    ok = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), ok), what
    scale = float(want[ok].abs().max()) if ok.any() else 0.0
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-4,
                               atol=1e-4 * scale + 1e-30, msg=what)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("identity", [False, True])
def test_frontend_kernel_matches_compute_columns(cuda, degree, identity):
    """One frontend_forward launch against compute_columns on the card at
    SH 0-3, on rows at the near plane, off screen, with a NaN det, an
    underflowing covariance, a zero quaternion and on the colour and
    frustum clamps' ties: radius and valid exactly, the packed rows (the
    sentinels included) within an ulp or two."""
    h, w = 96, 128
    g, pose, fx, fy, cx, cy = frontend_scene(3000, h, w, degree, cuda,
                                             identity=identity)
    want, plain = packed_plain(g, pose, fx, fy, cx, cy, degree, h, w)
    before = FE.FE_FORWARD.launches
    rows, key, cols = FE.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, degree,
                                       h, w)
    torch.cuda.synchronize()
    assert FE.FE_FORWARD.launches == before + 1
    assert torch.equal(cols.valid, plain.valid)
    assert torch.equal(cols.radius, plain.radius)
    assert 0 < int(cols.valid.sum()) < 3000
    torch.testing.assert_close(rows, want, rtol=1e-6, atol=0,
                               equal_nan=True)
    assert torch.equal(key, rows[:, 9])


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
@pytest.mark.parametrize("identity", [False, True])
def test_frontend_backward_matches_autograd(cuda, degree, identity):
    """The gradients of every Gaussian field and of the pose (through
    quat_to_rotmat) from one frontend_backward and one
    frontend_pose_reduce launch, against autograd through compute_columns
    on the card, for random upstream gradients of the rows: features_rest
    zero past the degree, the ties' half gradients."""
    h, w = 96, 128
    g, pose, fx, fy, cx, cy = frontend_scene(
        3000, h, w, 10 + degree, cuda, degenerate=False, identity=identity)
    leaves = _fe_leaves(g, pose)
    for x in leaves:
        x.requires_grad_(True)
    upstream = torch.randn((3000, 10), generator=torch.Generator(
        device=cuda).manual_seed(degree), device=cuda)
    want = torch.autograd.grad(
        packed_plain(g, pose, fx, fy, cx, cy, degree, h, w)[0], leaves,
        upstream, allow_unused=True)
    before = (FE.FE_BACKWARD.launches, FE.FE_POSE.launches)
    rows, _, _ = FE.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, degree, h, w)
    got = torch.autograd.grad(rows, leaves, upstream)
    torch.cuda.synchronize()
    assert (FE.FE_BACKWARD.launches, FE.FE_POSE.launches) == tuple(
        b + 1 for b in before)
    for name, a, b in zip([*FE.FIELDS, "pose"], got, want):
        _fe_close(a, torch.zeros_like(a) if b is None else b, name)
    k = (degree + 1) ** 2 - 1
    assert not got[5][:, k:].any()


def test_frontend_pose_only_backward(cuda):
    """With the Gaussians frozen (the pose refiner) the backward writes no
    Gaussian gradient and gives the pose the full backward's bits."""
    h, w = 96, 128
    g, pose, fx, fy, cx, cy = frontend_scene(5000, h, w, 3, cuda,
                                             degenerate=False)
    upstream = torch.randn((5000, 10), device=cuda)
    pose.requires_grad_(True)
    rows, _, _ = FE.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, 1, h, w)
    (alone,) = torch.autograd.grad(rows, [pose], upstream)
    leaves = _fe_leaves(g, pose)
    for x in leaves:
        x.requires_grad_(True)
    rows, _, _ = FE.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, 1, h, w)
    full = torch.autograd.grad(rows, leaves, upstream)
    assert torch.equal(alone, full[-1])
    want = torch.autograd.grad(packed_plain(g, pose, fx, fy, cx, cy, 1, h,
                                            w)[0], [pose], upstream)[0]
    _fe_close(alone, want, "pose")


def test_frontend_is_the_same_every_call(cuda):
    """Two forward and backward calls give the same bits (the pose sums
    use no float atomics)."""
    h, w = 96, 128
    g, pose, fx, fy, cx, cy = frontend_scene(20_000, h, w, 4, cuda,
                                             degenerate=False)
    leaves = _fe_leaves(g, pose)
    for x in leaves:
        x.requires_grad_(True)
    upstream = torch.randn((20_000, 10), device=cuda)
    outs = []
    for _ in range(2):
        rows, key, cols = FE.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, 0,
                                           h, w)
        outs.append([rows, key, cols.radius, cols.valid,
                     *torch.autograd.grad(rows, leaves, upstream)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_frontend_captured_graph_serves_two_views(cuda):
    """One CUDA graph of the front end's forward and backward, replayed for
    two views whose pose and intrinsics are copied into its inputs between
    replays: each replay gives that view's eager rows and gradients."""
    h, w = 96, 128
    g, pose0, fx0, fy0, cx0, cy0 = frontend_scene(4000, h, w, 5, cuda,
                                                  degenerate=False)
    _, pose1, *_ = frontend_scene(4000, h, w, 6, cuda, degenerate=False)
    views = [(pose0, torch.stack([fx0, fy0, cx0, cy0])),
             (pose1, torch.stack([fx0 * 1.1, fy0 * 0.9, cx0 - 3, cy0 + 2]))]
    leaves = _fe_leaves(g, pose0)[:-1]
    for x in leaves:
        x.requires_grad_(True)
    upstream = torch.randn((4000, 10), device=cuda)
    pose_s = pose0.clone().requires_grad_(True)
    intr_s = views[0][1].clone()

    def step():
        rows, _, cols = FE.frontend_rows(g, pose_s, *intr_s.unbind(), 1.0, 1,
                                         h, w)
        return [rows, cols.radius,
                *torch.autograd.grad(rows, leaves + [pose_s], upstream)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    captured = FE.FE_FORWARD.captured
    with torch.cuda.graph(graph):
        outs = step()
    assert FE.FE_FORWARD.captured == captured + 1
    for pose, intr in views:
        with torch.no_grad():
            pose_s.copy_(pose)
            intr_s.copy_(intr)
        graph.replay()
        torch.cuda.synchronize()
        p = pose.clone().requires_grad_(True)
        rows, _, cols = FE.frontend_rows(g, p, *intr.unbind(), 1.0, 1, h, w)
        eager = [rows, cols.radius,
                 *torch.autograd.grad(rows, leaves + [p], upstream)]
        for a, b in zip(outs, eager):
            assert torch.equal(a, b)


def test_frontend_step_launches(cuda):
    """prepare_packed_splats and its backward on a CUDA tensor: one forward
    launch, one backward and one pose sum, and under 250 device kernels in
    all (torch.profiler: quat_to_rotmat and its autograd, the sort, the
    gather and its backward; 177 on an H100), where compute_columns and
    its autograd took over a thousand."""
    from torch.profiler import ProfilerActivity, profile

    h, w = 96, 128
    g, pose, fx, fy, cx, cy = frontend_scene(3000, h, w, 7, cuda,
                                             degenerate=False)
    leaves = _fe_leaves(g, pose)
    for x in leaves:
        x.requires_grad_(True)

    def run():
        packed, _ = prepare_packed_splats(g, pose, fx, fy, cx, cy, 1.0, 0,
                                          h, w)
        return torch.autograd.grad(packed, leaves, torch.ones_like(packed))

    run()
    torch.cuda.synchronize()
    counts = [k.launches for k in (FE.FE_FORWARD, FE.FE_BACKWARD, FE.FE_POSE)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    assert [k.launches for k in (FE.FE_FORWARD, FE.FE_BACKWARD,
                                 FE.FE_POSE)] == [c + 1 for c in counts]
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    names = {e.name for e in kernels}
    assert any("frontend_forward_kernel" in n for n in names)
    assert any("frontend_backward_kernel" in n for n in names)
    assert 0 < len(kernels) < 250, len(kernels)
