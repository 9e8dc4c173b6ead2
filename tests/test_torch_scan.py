"""The device-resident loops (JAX's make_train_scan / TrainerConfig.scan,
the pose refiner's and the aligner's fori_loop blocks) on the CPU, where
each block's step runs in a Python loop (utils/cuda_graphs.StepLoop; on a
card the same step is captured once and replayed, tests/test_torch_gpu.py):

(a) the port's make_train_scan block of five iterations against JAX's
    make_train_scan, jitted whole, from test_torch_train's non-degenerate
    start: parameters and moments at rtol 1e-3 / atol 1e-5, the last
    iteration's metrics at rtol 1e-4 (test_torch_train's tolerances);
(b) train_joint with scan=True against scan=False: the same bits in the
    history and the parameters, for the dense and the binned / tiled
    plain paths, across log and SH-ramp boundaries and from a resume at
    first_iter > 0;
(c) the refiner and the aligner against the eager loops they replaced
    (kept here as references): the same bits;
(d) the block in which auto's re-probe demotes binned runs the dense
    step; a block whose lists overflow is demoted at its end, with the
    guard's warning, and the next block runs dense.
"""

import dataclasses
import logging
import math

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.convert import gaussians_from_numpy, to_numpy
from instantsplat_tpu_torch.data.scene import read_scene
from instantsplat_tpu_torch.init import aligner as al
from instantsplat_tpu_torch.models.camera import Camera, stack_cameras
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops.losses import masked_l1_loss
from instantsplat_tpu_torch.opt.gaussian_opt import (GaussianOptimizer,
                                                     OptimizationConfig)
from instantsplat_tpu_torch.pipelines import render_pipeline as rp
from instantsplat_tpu_torch.pipelines import trainer as tr
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop
from torch_init_cases import aligner_case
from torch_scenes import H, W, refine_case, write_tiny_scene

torch.set_num_threads(2)

OPT = dict(pp_optimizer=True, optim_pose=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan") / "scene"
    write_tiny_scene(root)
    return root, read_scene(root, 3, device="cpu")


def _start(info, seed=11):
    """test_torch_train's non-degenerate start: the scene's Gaussians with
    seeded anisotropic scales, random rotations and opacities."""
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=2, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    arrays = to_numpy(g)
    rng = np.random.default_rng(seed)
    n = g.num_points
    arrays["scaling"] = arrays["scaling"] + rng.normal(size=(n, 3)) * 0.3
    arrays["rotation"] = rng.normal(size=(n, 4))
    arrays["opacity"] = rng.normal(size=(n, 1))
    return {k: np.asarray(v, np.float32) if k != "max_sh_degree" else v
            for k, v in arrays.items()}


# ---- (a) make_train_scan against JAX's ---------------------------------


def test_train_scan_block_matches_jax(scene):
    import jax.numpy as jnp

    from instantsplat_tpu.data.scene import read_scene as jread
    from instantsplat_tpu.models.camera import stack_cameras as jstack
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    from instantsplat_tpu.opt.gaussian_opt import (
        GaussianOptimizer as JOpt, OptimizationConfig as JOptConfig)
    from instantsplat_tpu.pipelines.trainer import (
        make_train_scan as jmake_train_scan)

    root, info = scene
    arrays = _start(info)
    views, iters, active_sh = [2, 0, 1, 1, 0], [1, 2, 3, 4, 5], 1
    radius = info.nerf_radius

    jopt = JOpt(JOptConfig(**OPT), spatial_lr_scale=radius,
                total_iterations=10)
    jp = JG(**{k: jnp.asarray(arrays[k]) for k in PARAM_FIELDS},
            max_sh_degree=2)
    jstate = jopt.init(jp)
    jblock = jmake_train_scan(jopt, jstack(jread(root, 3).cameras),
                              jnp.zeros(3), 0.2, "oracle", 256)
    jp, jstate, jm = jblock(jp, jstate, jnp.asarray(views, jnp.int32),
                            jnp.asarray(iters, jnp.int32), active_sh)

    opt = GaussianOptimizer(OptimizationConfig(**OPT),
                            spatial_lr_scale=radius, total_iterations=10)
    tp = gaussians_from_numpy(arrays, 2, device="cpu")
    state = opt.init(tp)
    block = tr.make_train_scan(opt, stack_cameras(info.cameras),
                               torch.zeros(3), 0.2, "oracle", 256)
    tp, state, tm = block(tp, state, views, iters, active_sh)

    assert state.step == int(jstate.step) == 5
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-3,
                                   atol=1e-5, err_msg=f)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                getattr(state, mom)[f].numpy(),
                np.asarray(getattr(getattr(jstate, mom), f)), rtol=1e-3,
                atol=1e-5, err_msg=f"{mom} {f}")
    assert sorted(tm) == sorted(jm)
    for key in tm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, err_msg=key)


# ---- (b) scan=True against scan=False ----------------------------------


def _train(info, arrays, backend, scan, iterations, first_iter=0,
           opt_state=None):
    g = gaussians_from_numpy(arrays, 2, device="cpu")
    return train_joint(g, info.cameras, OptimizationConfig(**OPT),
                       TrainerConfig(iterations=iterations, backend=backend,
                                     log_every=3, sh_up_interval=4,
                                     scan=scan),
                       spatial_lr_scale=info.nerf_radius,
                       opt_state=opt_state, first_iter=first_iter)


def _copy_state(state):
    return dataclasses.replace(
        state, m={k: t.clone() for k, t in state.m.items()},
        v={k: t.clone() for k, t in state.v.items()})


def _history(h):
    return [(it, {k: v for k, v in m.items() if k != "elapsed_s"})
            for it, m in h]


def _assert_same_bits(a, b):
    (pa, sa, ha), (pb, sb, hb) = a, b
    assert _history(ha) == _history(hb)
    assert sa.step == sb.step
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(pa, f), getattr(pb, f)), f
        assert torch.equal(sa.m[f], sb.m[f]) and torch.equal(sa.v[f],
                                                             sb.v[f]), f


@pytest.mark.parametrize("backend", ["pallas", "pallas-binned:16:24",
                                     "pallas-tiled:16:12:2"])
def test_scan_is_bit_equal_to_eager(scene, backend):
    """9 iterations: log boundaries at 3, 6, 9 and SH ramps at 4 and 8
    (blocks 1-3, 4-6, 7, 8-9), then 2 more from a resume at iteration 9.
    The capacity strings hold the scene with room (no demotion)."""
    _, info = scene
    arrays = _start(info, seed=5)
    runs = {scan: _train(info, arrays, backend, scan, 9)
            for scan in (True, False)}
    _assert_same_bits(runs[True], runs[False])
    assert [it for it, _ in runs[True][2]] == [3, 6, 9]
    p9, s9, _ = runs[False]
    resumed = {}
    for scan in (True, False):
        start = {f: getattr(p9, f).numpy().copy() for f in PARAM_FIELDS}
        resumed[scan] = _train(info, start, backend, scan, 11, first_iter=9,
                               opt_state=_copy_state(s9))
    _assert_same_bits(resumed[True], resumed[False])
    assert [it for it, _ in resumed[True][2]] == [11]
    assert resumed[True][1].step == 11


# ---- (c) refiner and aligner against their eager loops --------------------


def _eager_refine(params, camera, pose0, gt, backend, num_iter, lr_t=3e-3,
                  lr_q=1e-3, lr_min=1e-4, weight_decay=1e-4):
    """make_pose_refiner's loop as the port ran it eagerly: host-indexed
    tables, new tensors every step."""
    beta1, beta2, eps = 0.9, 0.999, 1e-8
    t = torch.arange(num_iter, dtype=torch.float32)
    cos = (1 + torch.cos(math.pi * t / num_iter)) / 2
    lr = torch.stack([lr_min + (lr_q - lr_min) * cos] * 4
                     + [lr_min + (lr_t - lr_min) * cos] * 3, dim=1)
    bc1 = 1 - torch.pow(torch.tensor(beta1), t + 1.0)
    bc2 = 1 - torch.pow(torch.tensor(beta2), t + 1.0)
    bg = torch.zeros(3)
    pose = torch.as_tensor(pose0, dtype=torch.float32).clone()
    m, v = torch.zeros_like(pose), torch.zeros_like(pose)
    best_pose, best_loss = pose.clone(), torch.tensor(math.inf)
    for k in range(num_iter):
        pose.requires_grad_(True)
        out = driver.render(params, camera, pose=pose, bg=bg,
                            backend=backend)
        loss = masked_l1_loss(out.render, gt, out.render.detach() > 0.0)
        (g,) = torch.autograd.grad(loss, [pose])
        with torch.no_grad():
            pose, loss = pose.detach(), loss.detach()
            g = g + weight_decay * pose
            m = beta1 * m + (1 - beta1) * g
            v = beta2 * v + (1 - beta2) * g * g
            upd = lr[k] * (m / bc1[k]) / (torch.sqrt(v / bc2[k]) + eps)
            best_pose = torch.where(loss < best_loss, pose, best_pose)
            best_loss = torch.minimum(loss, best_loss)
            pose = pose - upd
    return best_pose, best_loss


def test_refiner_is_bit_equal_to_eager():
    """Two views through one refiner (the second reuses its tensors),
    each against the eager loop."""
    arrays, M, gt, start = refine_case()
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                        width=W, device="cpu")
    refine = rp.make_pose_refiner(g, cam, backend="pallas", num_iter=12)
    for pose0, intr in ((start, None), (start * 0.999, (61.0, 59.0, 31.0,
                                                        24.0))):
        c = cam if intr is None else Camera.create(
            M[:3, :3], M[:3, 3], fx=intr[0], fy=intr[1], cx=intr[2],
            cy=intr[3], height=H, width=W, device="cpu")
        want = _eager_refine(g, c, pose0, torch.tensor(gt), "pallas", 12)
        got = refine(pose0, torch.tensor(gt), intr=None if intr is None
                     else tuple(torch.tensor(x) for x in intr))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _eager_align(aligner, niter, lr=0.01, lr_min=1e-6):
    """GlobalAligner.align's cosine loop as the port ran it eagerly: host
    float32 scalars every iteration."""
    buffers = aligner._buffers("cpu")
    params = {k: torch.tensor(v).requires_grad_()
              for k, v in aligner.params.items()}
    trainable = dict(pw_poses=True, im_poses=not aligner.poses_frozen,
                     im_depth=True, im_focals=not aligner.focals_frozen)
    beta1, beta2, eps = 0.9, 0.9, 1e-8
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    f32 = np.float32
    for it in range(niter):
        t = f32(it) / f32(niter)
        cur_lr = f32(lr_min) + (f32(lr) - f32(lr_min)) * (
            f32(1) + np.cos(t * f32(math.pi))) / f32(2)
        bc1 = f32(1) - f32(beta1) ** f32(it + 1)
        bc2 = f32(1) - f32(beta2) ** f32(it + 1)
        grads = torch.autograd.grad(aligner._loss(params, buffers),
                                    list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                v[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                if trainable[k]:
                    p.sub_(float(cur_lr) * (m[k] / float(bc1)) / (
                        torch.sqrt(v[k] / float(bc2)) + eps))
    with torch.no_grad():
        loss = aligner._loss(params, buffers)
    return {k: p.detach().numpy() for k, p in params.items()}, float(loss)


def test_aligner_is_bit_equal_to_eager():
    ref = al.GlobalAligner(aligner_case(), device="cpu")
    ref.init_mst(focal_avg=True)
    want, want_loss = _eager_align(ref, 30)
    got = al.GlobalAligner(aligner_case(), device="cpu")
    got.init_mst(focal_avg=True)
    loss = got.align(niter=30)
    assert loss == want_loss
    for k, p in want.items():
        np.testing.assert_array_equal(got.params[k], p, err_msg=k)


# ---- (d) demotion inside and between blocks --------------------------------


@pytest.fixture
def fresh_guard():
    driver.reset_overflow_guard()
    yield
    driver.reset_overflow_guard()


def _backends_by_iteration(monkeypatch, first_iter=0):
    """{iteration: backend its render was given}: on the CPU a block's
    steps render one after another, one render an iteration."""
    seen = []
    real = tr.render

    def spy(*a, backend, **k):
        seen.append(backend)
        return real(*a, backend=backend, **k)

    monkeypatch.setattr(tr, "render", spy)
    return lambda: {first_iter + 1 + i: b for i, b in enumerate(seen)}


def test_demoting_block_runs_dense(scene, monkeypatch, capsys, fresh_guard):
    """auto's re-probe at iteration 9 finds the winning capacity
    candidate no longer fits: that very block (9-10) and every later one
    run the dense step (the JAX trainer runs its demoting block on the
    stale binned program)."""
    _, info = scene
    arrays = _start(info, seed=3)
    g = gaussians_from_numpy(arrays, 2, device="cpu")
    base = driver.capacity_candidate(g, info.cameras[0])
    assert base is not None
    answers = iter([base, None])
    monkeypatch.setattr(driver, "capacity_candidate",
                        lambda params, camera: next(answers))
    monkeypatch.setattr(tr, "_REPROBE_EVERY", 8)
    now = [0.0]

    def clock():  # the candidate wins the probe: dense blocks are slow
        now[0] += 1.0
        return now[0]

    monkeypatch.setattr(tr, "_clock", clock)
    real_scan = tr.make_train_scan

    def scan(optimizer, cameras, bg, lam, backend, chunk, **kw):
        block = real_scan(optimizer, cameras, bg, lam, backend, chunk, **kw)

        def timed(params, state, views, iters, sh):
            now[0] += len(iters) * (10.0 if backend == "pallas" else 1.0)
            return block(params, state, views, iters, sh)

        return timed

    monkeypatch.setattr(tr, "make_train_scan", scan)
    backends = _backends_by_iteration(monkeypatch)
    train_joint(g, info.cameras, OptimizationConfig(**OPT),
                TrainerConfig(iterations=14, log_every=2, backend="auto"),
                spatial_lr_scale=info.nerf_radius)
    out = capsys.readouterr().out
    b = backends()
    assert "binned (" in out and "demoting binned at iter 9" in out, out
    assert [b[i] for i in range(1, 9)] == ["pallas"] * 4 + [base] * 4
    assert all(b[i] == "pallas" for i in range(9, 15)), b


def test_block_overflow_demotes_at_block_end(scene, monkeypatch, caplog,
                                             fresh_guard):
    """An overflowing capacity string inside a block: every call's flag
    is recorded, the warning comes once at the block's end, the block ran
    the capacity step throughout, and the next block runs dense."""
    _, info = scene
    arrays = _start(info, seed=3)
    g = gaussians_from_numpy(arrays, 2, device="cpu")
    backends = _backends_by_iteration(monkeypatch)
    seen = []
    real = driver.composite_lists
    monkeypatch.setattr(driver, "composite_lists",
                        lambda *a: seen.append(1) or real(*a))
    with caplog.at_level(logging.WARNING):
        train_joint(g, info.cameras, OptimizationConfig(**OPT),
                    TrainerConfig(iterations=6, log_every=3,
                                  backend="pallas-tiled:1:1:1"))
    warned = [r for r in caplog.records if "auto-switching" in r.message]
    assert len(warned) == 1 and len(driver.demoted()) == 1
    assert len(seen) == 3  # block 1-3 on the lists, block 4-6 dense
    assert all(b == "pallas-tiled:1:1:1" for b in backends().values())


def test_step_loop_on_the_cpu_is_a_python_loop():
    """run(n) calls the step n times and returns its last output."""
    calls = []
    loop = StepLoop(lambda: calls.append(1) or torch.tensor(len(calls)),
                    "cpu", "test")
    assert int(loop.run(4)) == 4 and not loop.captured
    assert int(loop.run(2)) == 6 and loop.graph is None


def test_loops_are_freed_without_the_cyclic_collector(scene, monkeypatch):
    """Every StepLoop of a train_joint, a refiner and an aligner is freed
    by reference counting once its owner is gone: a loop kept alive by a
    reference cycle would hold its CUDA graph for the cyclic collector,
    which may run while another graph is being captured, and destroying a
    graph then invalidates that capture."""
    import gc
    import weakref

    made = []

    class Spy(StepLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(weakref.ref(self))

    for module in (tr, rp, al):
        monkeypatch.setattr(module, "StepLoop", Spy)
    # the plain compositor's torch.utils.checkpoint keeps frames of the
    # call stack in cycles of its own (the card's kernels never call it):
    # the same chunk steps without it
    from instantsplat_tpu_torch.ops import rasterize

    monkeypatch.setattr(rasterize, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    _, info = scene
    arrays = _start(info)
    was_enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        _train(info, arrays, "pallas", True, 4)
        refine_arrays, M, gt, start = refine_case()
        g = GaussianModel(**{f: torch.tensor(v) for f, v in
                             refine_arrays.items()}, max_sh_degree=1)
        cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0,
                            height=H, width=W, device="cpu")
        refine = rp.make_pose_refiner(g, cam, num_iter=2)
        refine(start, torch.tensor(gt))
        del refine
        aligner = al.GlobalAligner(aligner_case(), device="cpu")
        aligner.init_mst(focal_avg=True)
        aligner.align(niter=2)
        assert len(made) == 4  # SH 0 and 1 blocks; the refiner; align
        assert all(ref() is None for ref in made)
    finally:
        if was_enabled:
            gc.enable()
