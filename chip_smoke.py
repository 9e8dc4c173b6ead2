#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stage 2 on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card and software: nvidia-smi name and power limit, torch/CUDA versions.
   Exits non-zero when torch.cuda.is_available() is false.
2. Build the CUDA kernels from instantsplat_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc per source, started together: rasterize.cu (K1 dense
   forward, K2 dense backward) and rasterize_lists.cu (K3/K4 binned, K5/K6
   tiled); print ptxas's report.
3. Kernel against plain version at the golden-case shape (64x48, 400
   splats) and a ragged mid size (250x187, 20k splats), for the dense
   kernels and for the binned and tiled ones at capacities sized for the
   splats, plus one deliberately overflowing capacity string each (kernel
   and plain version walk the same lists, so they drop the same pairs):
   acc and tfin within 5e-4, lc equal on >= 99.9% of pixels, d(packed)
   within a relative L2 of 1e-3 (and elementwise at the golden case).
4. Train: a synthetic 3-view sparse_3 scene (COLMAP text, points3D.ply,
   PNG images; 100k points, 512x384) through
   instantsplat_tpu_torch.cli.train.main for 200 iterations with
   --pp_optimizer --optim_pose --sh_degree 3, four times:
   --backend pallas (K1 and K2 launch once per iteration), --backend auto
   (prints which backend won; forward launches over K1/K3/K5 sum to 200),
   pallas-tiled:CF:DY:DX and pallas-binned:CF:DL sized by the port's
   tiled_/binned_view_requirements with headroom for the run: the larger
   of the requirement on the initial scene and on the dense run's final
   one (this scene's splats grow ~5x in 200 iterations), plus a margin.
   K5 and K6, or K3 and K4, launch 200 times each; a demotion by the
   overflow guard fails the run. A second dense run measures the
   run-to-run spread. Every loss must fall and each curve must stay within
   LOSS_RTOL of the dense run's.
5. At the training shape, with the trained scene: each kernel against the
   plain version once more, the kernels' CUDA-event times, the plain
   version's times, and the least time the card could take (bytes over
   3.35 TB/s, operations over 67 TFLOP/s fp32).

The last lines are one JSON object {"kernels": [...]} with six entries,
the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_S = 67e12  # H100 SXM fp32 outside the tensor cores
# float operations per contributing (pixel, splat) pair, counted from
# csrc/rasterize.cu (each exp/log1p counted as one operation); the per-pair
# bodies of csrc/rasterize_lists.cu's forward and backward are the same
# statements, so K3/K5 count as K1 and K4/K6 as K2
K1_OPS_PER_PAIR = 29
K2_OPS_PER_PAIR = 57
TRAIN_ITERS = 200
N_POINTS = 100_000
H, W = 384, 512
SOURCES = ("rasterize.cu", "rasterize_lists.cu")
# Loss curves of the other runs against the dense run: each logged loss
# within 10% of the dense run's at the same iteration. Not tighter: the
# backward kernels add with atomics in a varying order, and Adam (eps
# 1e-15) turns last-bit differences of near-zero gradients into whole
# steps, so two runs part within a few iterations; a second dense run
# (phase 4) measures that spread, which reached 1.0e-2 on the H100.
LOSS_RTOL = 0.1
# Deliberately overflowing capacity strings for the kernel checks
OVERFLOW = {"binned": "pallas-binned:1:2", "tiled": "pallas-tiled:1:1:1"}


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# synthetic inputs (numpy seeds)
# --------------------------------------------------------------------------


def look_at_w2c(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    import numpy as np

    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows: camera axes in world
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = -R @ eye
    return M


def blob_splats(n, height, width, seed, device):
    """Packed, depth-sorted splats of a random blob in front of a camera
    (the golden case's construction, drawn with numpy)."""
    import numpy as np
    import torch

    from instantsplat_tpu_torch.models.camera import Camera
    from instantsplat_tpu_torch.models.gaussians import GaussianModel
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.6 + np.array([0.0, 0.0, 4.0])
    cols = rng.uniform(size=(n, 3))
    g = GaussianModel.create_from_pcd(
        pts, cols, cam_poses=np.array([[1.0, 0, 0, 0, 0, 0, 0]]),
        max_sh_degree=2, device=device)
    g.scaling += torch.tensor([0.4, -0.3, 0.1], device=device)
    g.opacity += torch.as_tensor(rng.normal(size=(n, 1)) * 2.0,
                                 dtype=torch.float32, device=device)
    f = 70.0 * width / 64.0
    cam = Camera.create(np.eye(3), np.zeros(3), fx=f, fy=f, height=height,
                        width=width, device=device)
    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            g, cam.pose, cam.fx, cam.fy, cam.cx, cam.cy, 1.0, 2, height,
            width)
    return packed.contiguous()


def surface(x, y):
    import numpy as np

    return 0.3 * np.sin(1.7 * x) * np.cos(2.3 * y)


def texture(x, y):
    import numpy as np

    c = np.stack([0.5 + 0.4 * np.sin(3.0 * x + 0.5 * y),
                  0.5 + 0.4 * np.cos(2.0 * y - 1.3 * x),
                  0.5 + 0.4 * np.sin(1.1 * x * y + 2.0)], -1)
    checker = ((np.floor(2 * x) + np.floor(2 * y)) % 2)[..., None]
    return np.clip(c * (0.75 + 0.25 * checker), 0.0, 1.0)


def write_scene(root: Path, seed: int = 0):
    """3-view sparse_3 scene: a textured relief surface, its colored point
    cloud and PNG renders of the surface texture."""
    import numpy as np

    from instantsplat_tpu_torch.data import colmap, png, ply

    rng = np.random.default_rng(seed)
    fx = 0.9 * W
    xy = rng.uniform([-3.0, -2.2], [3.0, 2.2], size=(N_POINTS, 2))
    pts = np.concatenate([xy, surface(xy[:, 0], xy[:, 1])[:, None]], 1)
    cols = texture(xy[:, 0], xy[:, 1])
    sparse = root / "sparse_3" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    ply.store_point_cloud(sparse / "points3D.ply", pts, cols * 255.0)
    cams, ims = {}, {}
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for i, ang in enumerate((-0.15, 0.0, 0.15)):
        w2c = look_at_w2c((4.0 * np.sin(ang), 0.3, -4.0 * np.cos(ang)))
        c2w = np.linalg.inv(w2c)
        d = np.stack([(gx - (W - 1) / 2) / fx, (gy - (H - 1) / 2) / fx,
                      np.ones_like(gx, np.float64)], -1) @ c2w[:3, :3].T
        o = c2w[:3, 3]
        t = -o[2] / d[..., 2]  # plane z = 0, then fixed-point refinement
        for _ in range(8):
            p = o + t[..., None] * d
            t = (surface(p[..., 0], p[..., 1]) - o[2]) / d[..., 2]
        p = o + t[..., None] * d
        img = texture(p[..., 0], p[..., 1])
        name = f"{i:03d}.png"
        png.write_png(root / "images" / name,
                      np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8))
        cams[i + 1] = colmap.ColmapCamera(
            i + 1, "PINHOLE", W, H, np.array([fx, fx, W / 2, H / 2]))
        ims[i + 1] = colmap.ColmapImage(
            i + 1, colmap.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], i + 1,
            name)
    colmap.write_cameras_text(cams, sparse / "cameras.txt")
    colmap.write_images_text(ims, sparse / "images.txt")


# --------------------------------------------------------------------------
# kernel against plain version
# --------------------------------------------------------------------------


def backend_paths(backend: str, packed, height, width):
    """(kernel names, plain(p) -> (acc, tfin, lc), kernel fwd(), kernel
    bwd(g_acc, gtu, tfin, lc), lists) for the dense backend "pallas" or a
    capacity backend string; the list backends build their lists once, so
    the kernel and the plain version walk the same ones."""
    from instantsplat_tpu_torch.ops import rasterize_lists as RL
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
    from instantsplat_tpu_torch.ops.rasterize import composite_plain
    from instantsplat_tpu_torch.render import driver

    if backend == "pallas":
        rect, batch = RP.splat_rects(packed, height, width)
        return (("K1", "K2"),
                lambda p: composite_plain(p, height, width),
                lambda: RP.k1_forward(packed, rect, batch, height, width),
                lambda ga, gtu, tf, lc: RP.k2_backward(packed, rect, batch,
                                                       ga, gtu, tf, lc),
                None)
    if backend.startswith("pallas-binned"):
        lists, geom = RB.bin_lists(packed, height, width,
                                   *driver._parse_binned_caps(backend))
        names, fwd, bwd = ("K3", "K4"), RB.K3, RB.K4
    else:
        lists, geom = RT.tile_lists(packed, height, width,
                                    *driver._parse_tiled_caps(backend))
        names, fwd, bwd = ("K5", "K6"), RT.K5, RT.K6
    return (names,
            lambda p: RL.composite_lists_plain(p, lists, geom, height, width),
            lambda: RL.lists_forward(fwd, packed, lists, geom, height, width),
            lambda ga, gtu, tf, lc: RL.lists_backward(bwd, packed, lists,
                                                      geom, ga, gtu, tf, lc),
            lists)


def compare(tag, packed, height, width, seed, elementwise,
            backend="pallas"):
    """Hold a backend's forward and backward kernels against the plain
    version on the same inputs; returns the max abs differences (forward
    acc/tfin, backward d(packed))."""
    import numpy as np
    import torch

    dev = packed.device
    rng = np.random.default_rng(seed)
    g_acc = torch.as_tensor(rng.normal(size=(4, height, width)),
                            dtype=torch.float32, device=dev)
    g_acc[3] *= 1e-2  # depth cotangent at a scale like the colors'
    g_tfin = torch.as_tensor(rng.normal(size=(height, width)),
                             dtype=torch.float32, device=dev)
    (kf, kb), plain, k_fwd, k_bwd, lists = backend_paths(
        backend, packed, height, width)
    p = packed.detach().clone().requires_grad_(True)
    acc_p, tfin_p, lc_p = plain(p)
    (grad_p,) = torch.autograd.grad(
        (acc_p * g_acc).sum() + (tfin_p * g_tfin).sum(), [p])
    acc_k, tfin_k, lc_k = k_fwd()
    grad_k = k_bwd(g_acc, (g_tfin * tfin_k).contiguous(), tfin_k, lc_k)
    torch.cuda.synchronize()
    e_acc = (acc_k - acc_p.detach()).abs().max().item()
    e_tfin = (tfin_k - tfin_p.detach()).abs().max().item()
    lc_eq = (lc_k.long() == lc_p).float().mean().item()
    rel_l2 = ((grad_k - grad_p).norm() / grad_p.norm().clamp(min=1e-30)
              ).item()
    e_grad = (grad_k - grad_p).abs().max().item()
    lists_note = "" if lists is None else (
        f" [{backend}: overflow={bool(lists.overflow)}, "
        f"{int(lists.seg_count.sum())} list entries]")
    log(f"{tag}{lists_note}: N={packed.shape[0]} {width}x{height} {kf} acc "
        f"max|d|={e_acc:.3e} tfin max|d|={e_tfin:.3e} lc equal="
        f"{lc_eq * 100:.4f}% | {kb} d(packed) rel L2={rel_l2:.3e} "
        f"max|d|={e_grad:.3e} (max|ref|={grad_p.abs().max().item():.3e})")
    if not (e_acc <= 5e-4 and e_tfin <= 5e-4):
        fail(f"{tag}: {kf} differs from the plain version beyond 5e-4")
    if lc_eq < 0.999:
        fail(f"{tag}: {kf} last-contributor index equal on only "
             f"{lc_eq * 100:.3f}% of pixels (< 99.9%)")
    if not rel_l2 <= 1e-3:
        fail(f"{tag}: {kb} gradient relative L2 {rel_l2:.3e} > 1e-3")
    if elementwise:
        # the JAX suite's kernel-vs-golden gradient tolerance
        # (tests/test_golden.py: rtol 5e-3, atol 1e-5)
        bad = (grad_k - grad_p).abs() > 1e-5 + 5e-3 * grad_p.abs()
        if bool(bad.any()):
            fail(f"{tag}: {int(bad.sum())} {kb} gradient entries outside "
                 "rtol 5e-3 / atol 1e-5")
    return e_acc, e_grad


def sized_backends(packed, height, width, headroom=(0, 0, 0)):
    """{"binned": "pallas-binned:CF:DL", "tiled": "pallas-tiled:CF:DY:DX"}
    sized by the port's requirements for these splats, plus `headroom`
    added to (cap_factor, level, level)."""
    from instantsplat_tpu_torch.ops import rasterize_lists as RL
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT

    cols = (packed[:, :2], packed[:, 2:5], packed[:, 5],
            RL.splat_valid(packed))
    cf, dl = RB.bin_requirements(*cols, height, width)
    tcf, dy, dx = RT.tile_requirements(*cols, height, width)
    hc, hl, hx = headroom
    return {"binned": f"pallas-binned:{cf + hc}:{dl + hl}",
            "tiled": f"pallas-tiled:{tcf + hc}:{dy + hl}:{dx + hx}"}


def compare_all(tag, packed, height, width, seed, elementwise,
                overflow=False):
    """The dense, binned and tiled kernels against the plain version; with
    `overflow`, also the deliberately overflowing strings. -> {kernel
    name: (forward err, backward err)} of the sized strings."""
    errs = {"dense": compare(tag, packed, height, width, seed, elementwise)}
    for kind, backend in sized_backends(packed, height, width).items():
        errs[kind] = compare(tag, packed, height, width, seed, elementwise,
                             backend)
    if overflow:
        for kind, backend in OVERFLOW.items():
            (_, _, _, _, lists) = backend_paths(backend, packed, height,
                                                width)
            if not bool(lists.overflow):
                fail(f"{tag}: {backend} was meant to overflow and did not")
            compare(tag + " overflowing", packed, height, width, seed,
                    elementwise, backend)
    return errs


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def contributing_pairs(packed, height, width, chunk=256) -> int:
    """(pixel, splat) pairs that contribute to the image: the work the
    compositing rules require for these inputs."""
    import torch

    from instantsplat_tpu_torch.ops.rasterize import (
        ALPHA_EPS, ALPHA_MAX, LOG_TERM, pixel_coords)

    px, py = pixel_coords(height, width, packed.device)
    logT = torch.zeros_like(px)
    done = torch.zeros_like(px, dtype=torch.bool)
    total = 0
    with torch.no_grad():
        for s in range(0, packed.shape[0], chunk):
            blk = packed[s:s + chunk]
            dx = px[:, None] - blk[None, :, 0]
            dy = py[:, None] - blk[None, :, 1]
            power = (-0.5 * (blk[None, :, 2] * dx * dx
                             + blk[None, :, 4] * dy * dy)
                     - blk[None, :, 3] * dx * dy)
            alpha = torch.clamp(torch.exp(power + blk[None, :, 5]),
                                max=ALPHA_MAX)
            alpha = torch.where((power > 0) | (alpha < ALPHA_EPS), 0.0, alpha)
            l = torch.log1p(-alpha)
            post = logT[:, None] + torch.cumsum(l, 1)
            done_seq = done[:, None] | (torch.cumsum(
                ((alpha > 0) & (post < LOG_TERM)).int(), 1) > 0)
            contrib = (alpha > 0) & ~done_seq
            total += int(contrib.sum())
            logT = logT + torch.where(contrib, l, 0.0).sum(1)
            done = done_seq[:, -1]
    return total


def profile_iterations(params, cam, dev, iters: int = 10):
    """Device time per training iteration by kernel name (torch.profiler
    over `iters` steady steps of the training step on one view), and the
    share of the window's wall time the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True),
                            total_iterations=TRAIN_ITERS)
    state = opt.init(params)
    bg = torch.zeros(3, device=dev)

    def step(i):
        float(train_step(params, cam, opt, state, i, 0, bg, 0.2, "auto",
                         256)["loss"])  # per-iteration loss read, as trained

    for i in range(3):
        step(i + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for i in range(iters):
            step(i + 4)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not by_name:
        log("profile: torch.profiler recorded no device events")
        return
    log(f"profile: {iters} iterations, {wall_ms / iters:.2f} ms/iter wall "
        f"(profiler on), device busy {busy_ms / iters:.2f} ms/iter = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%)"
        f", {len(by_name)} kernel names")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"profile: {ms / iters:8.3f} ms/iter {100 * ms / busy_ms:5.1f}% "
            f"{name[:110]}")


def kernel_table():
    """{name: Kernel} of the six kernels, in order."""
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT

    return {"K1": RP.K1, "K2": RP.K2, "K3": RB.K3, "K4": RB.K4,
            "K5": RT.K5, "K6": RT.K6}


class _Tee:
    """stdout that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def train_run(scene: Path, out: Path, backend: str, log_every: int):
    """One 200-iteration training run through the CLI. -> (params,
    history, launches {K1..K6}, seconds, the trainer's "backend auto"
    lines, the overflow guard's demotion warnings)."""
    import contextlib

    import torch

    from instantsplat_tpu_torch.cli import train as train_cli
    from instantsplat_tpu_torch.render import driver

    # each run starts with no capacity signature checked or demoted
    driver._guard = driver._OverflowGuard()
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    tee = _Tee(sys.stdout)
    warns = _Warnings()
    guard_log = logging.getLogger("instantsplat_tpu_torch.render.driver")
    guard_log.addHandler(warns)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(tee):
            params, history = train_cli.main([
                "-s", str(scene), "-m", str(out), "--n_views", "3",
                "--iterations", str(TRAIN_ITERS), "--pp_optimizer",
                "--optim_pose", "--sh_degree", "3", "--log_every",
                str(log_every), "--backend", backend, "--quiet"])
        torch.cuda.synchronize()
    finally:
        guard_log.removeHandler(warns)
    seconds = time.time() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    auto_lines = [ln for ln in "".join(tee.text).splitlines()
                  if "backend auto" in ln]
    return params, history, launches, seconds, auto_lines, warns.messages


def check_run(tag, history, launches, seconds, demotions, log_every,
              dense_losses=None):
    """Losses finite and falling, the history complete, no demotion, and
    (with dense_losses) the curve within LOSS_RTOL of the dense run's.
    -> steady ms/iter over the last 100 iterations."""
    losses = {it: m["loss"] for it, m in history}
    elapsed = {it: m["elapsed_s"] for it, m in history}
    steady_ms = (elapsed[TRAIN_ITERS] - elapsed[TRAIN_ITERS - 100]) * 10.0
    its = sorted(losses)
    log(f"train {tag}: {len(history)} logged iterations in {seconds:.1f} s "
        f"(scene read, KNN and artifacts included); loss "
        f"{losses[its[0]]:.5f} -> {losses[its[-1]]:.5f}; steady "
        f"{steady_ms:.2f} ms/iter over the last 100 = "
        f"{H * W / (steady_ms / 1e3) / 1e6:.2f} Mpix/s; launches {launches}")
    for msg in demotions:
        log(f"train {tag}: overflow guard: {msg}")
    if len(history) != TRAIN_ITERS // log_every:
        fail(f"{tag}: history has {len(history)} entries, expected "
             f"{TRAIN_ITERS // log_every}")
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f"{tag}: non-finite loss")
    if not losses[its[-1]] < losses[its[0]]:
        fail(f"{tag}: the loss did not fall")
    if dense_losses is not None:
        rel = max(abs(losses[it] - dense_losses[it]) / dense_losses[it]
                  for it in its)
        log(f"train {tag}: loss curve against the dense run: max relative "
            f"difference {rel:.3e} over {len(its)} logged iterations "
            f"(limit {LOSS_RTOL:g}); first logged iteration "
            f"{abs(losses[its[0]] - dense_losses[its[0]]) / dense_losses[its[0]]:.3e}")
        if not rel <= LOSS_RTOL:
            fail(f"{tag}: loss curve differs from the dense run's by "
                 f"{rel:.3e} > {LOSS_RTOL:g}")
    return steady_ms


def initial_params(scene: Path, dev):
    """The Gaussians and cameras run_training starts from."""
    from instantsplat_tpu_torch.data.scene import read_scene
    from instantsplat_tpu_torch.models.gaussians import GaussianModel

    info = read_scene(scene, 3, device=dev)
    params = GaussianModel.create_from_pcd(
        info.points, info.colors,
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c),
        max_sh_degree=3, device=dev)
    return params, info.cameras


def view_requirements(params, cameras):
    """Elementwise maxima over the views of the port's binned and tiled
    requirements (drift margin included)."""
    from instantsplat_tpu_torch.render import driver

    b = [driver.binned_view_requirements(params, params.get_pose(c.uid), c)
         for c in cameras]
    t = [driver.tiled_view_requirements(params, params.get_pose(c.uid), c)
         for c in cameras]
    return tuple(map(max, zip(*b))), tuple(map(max, zip(*t)))


def main():
    import numpy as np
    import torch

    # ---- phase 1: card ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    csrc = REPO / "instantsplat_tpu_torch" / "csrc"
    if not all((csrc / src).is_file() for src in SOURCES):
        fail(f"instantsplat_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"python {sys.version.split()[0]}")
    # full float32 everywhere: the plain version's matmul and anything
    # cuDNN might see
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from instantsplat_tpu_torch.ops import cuda_build

    # ---- phase 2: build, one nvcc per source, all started together -------
    t0 = time.time()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(cuda_build.build, SOURCES))
    log(f"built {', '.join(str(lib.relative_to(REPO)) for lib in libs)} in "
        f"{time.time() - t0:.1f} s")
    for src in SOURCES:
        for line in cuda_build.ptxas_report(src).splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"ptxas {src}: {line.strip()}")

    # ---- phase 3: kernels against plain version --------------------------
    compare_all("golden-case shape", blob_splats(400, 48, 64, 42, dev), 48,
                64, seed=1, elementwise=True)
    compare_all("ragged mid size", blob_splats(20_000, 187, 250, 7, dev),
                187, 250, seed=2, elementwise=False, overflow=True)

    # ---- phase 4: train --------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        scene = Path(tmp) / "scene"
        write_scene(scene)
        log(f"scene: {N_POINTS} points, 3 views {W}x{H}, PNG images")
        torch.cuda.reset_peak_memory_stats()
        params, history, launches, secs, _, dem = train_run(
            scene, Path(tmp) / "dense", "pallas", 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = {"dense": check_run("dense (--backend pallas)", history,
                                     launches, secs, dem, 1)}
        log(f"train dense: peak memory {peak_gb:.2f} GB")
        out = Path(tmp) / "dense"
        for rel in ("point_cloud/iteration_200/point_cloud.ply",
                    "pose/ours_200/pose_optimized.npy", "cameras.json",
                    "cfg_args", "train_time.txt", "scalars.jsonl"):
            if not (out / rel).is_file():
                fail(f"training artifact missing: {rel}")
        if launches != {"K1": TRAIN_ITERS, "K2": TRAIN_ITERS, "K3": 0,
                        "K4": 0, "K5": 0, "K6": 0}:
            fail(f"dense run: kernel launches {launches} != {TRAIN_ITERS} "
                 "each of K1 and K2")
        # launches of each kernel on its own path's run
        path_launches = {"K1": launches["K1"], "K2": launches["K2"]}
        dense_losses = {it: m["loss"] for it, m in history}

        p0, cams = initial_params(scene, dev)
        (bcf, bdl), (tcf, tdy, tdx) = view_requirements(p0, cams)
        (fbcf, fbdl), (ftcf, ftdy, ftdx) = view_requirements(params, cams)
        log(f"requirements over the 3 views (margin included): initial "
            f"binned {bcf}:{bdl} tiled {tcf}:{tdy}:{tdx}; after the dense "
            f"run binned {fbcf}:{fbdl} tiled {ftcf}:{ftdy}:{ftdx}")
        cam = cams[0]
        del p0

        _, history, launches, secs, _, dem = train_run(
            scene, Path(tmp) / "dense2", "pallas", 1)
        check_run("dense, second run", history, launches, secs, dem, 1,
                  dense_losses)

        # auto: the probe times 10-iteration blocks, as with log_every 100
        _, history, launches, secs, auto_lines, dem = train_run(
            scene, Path(tmp) / "auto", "auto", 10)
        for ln in auto_lines:
            log(f"train auto: trainer said: {ln.strip()}")
        steady["auto"] = check_run("auto", history, launches, secs, dem, 10,
                                   dense_losses)
        fwd = launches["K1"] + launches["K3"] + launches["K5"]
        bwd = launches["K2"] + launches["K4"] + launches["K6"]
        if fwd != TRAIN_ITERS or bwd != TRAIN_ITERS:
            fail(f"auto run: forward launches {fwd}, backward {bwd}, "
                 f"expected {TRAIN_ITERS} each ({launches})")
        won = ("dense" if launches["K1"] > TRAIN_ITERS // 2 else
               "tiled" if launches["K5"] > TRAIN_ITERS // 2 else "binned")
        log(f"train auto: backend that ran most iterations: {won}")

        # explicit strings: sized on the initial scene, with headroom for
        # the drift of the whole run (as large as the dense run's)
        explicit = {
            "tiled": (f"pallas-tiled:{max(tcf, ftcf) + 1}:"
                      f"{max(tdy, ftdy) + 2}:{max(tdx, ftdx) + 1}",
                      ("K5", "K6")),
            "binned": (f"pallas-binned:{max(bcf, fbcf) + 1}:"
                       f"{max(bdl, fbdl) + 4}", ("K3", "K4"))}
        for kind, (backend, (kf, kb)) in explicit.items():
            _, history, launches, secs, _, dem = train_run(
                scene, Path(tmp) / kind, backend, 1)
            steady[kind] = check_run(f"{kind} ({backend})", history,
                                     launches, secs, dem, 1, dense_losses)
            if dem:
                fail(f"{kind} run: the overflow guard demoted {backend}")
            if launches[kf] != TRAIN_ITERS or launches[kb] != TRAIN_ITERS:
                fail(f"{kind} run: {kf}/{kb} launched {launches[kf]}/"
                     f"{launches[kb]} times, expected {TRAIN_ITERS}")
            path_launches.update({kf: launches[kf], kb: launches[kb]})
        log("steady ms/iter by backend: " + ", ".join(
            f"{k} {v:.2f}" for k, v in steady.items()))

    # ---- phase 5: the training shape, trained scene ----------------------
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            params, params.get_pose(0), cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
            params.max_sh_degree, H, W)
    packed = packed.contiguous()
    errs = compare_all("training shape", packed, H, W, seed=3,
                       elementwise=False)
    pairs = contributing_pairs(packed, H, W)
    n = packed.shape[0]
    sized = sized_backends(packed, H, W)
    rng = np.random.default_rng(4)
    g_acc = torch.as_tensor(rng.normal(size=(4, H, W)), dtype=torch.float32,
                            device=dev)
    g_tfin = torch.as_tensor(rng.normal(size=(H, W)), dtype=torch.float32,
                             device=dev)

    def bound(nbytes, ops):
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows = []
    sources = {"dense": ("rasterize.cu", "rasterize_pallas.py", 145, 265),
               "binned": ("rasterize_lists.cu", "rasterize_pallas_binned.py",
                          202, 270),
               "tiled": ("rasterize_lists.cu", "rasterize_pallas_tiled.py",
                         218, 291)}
    for kind in ("dense", "binned", "tiled"):
        backend = "pallas" if kind == "dense" else sized[kind]
        (kf, kb), plain, k_fwd, k_bwd, lists = backend_paths(
            backend, packed, H, W)
        acc_k, tfin_k, lc_k = k_fwd()
        gtu = (g_tfin * tfin_k).contiguous()
        f_ms = cuda_ms(k_fwd, 20)
        b_ms = cuda_ms(lambda: k_bwd(g_acc, gtu, tfin_k, lc_k), 20)
        with torch.no_grad():
            plain_f_ms = cuda_ms(lambda: plain(packed), 1, 1)
        pg = packed.clone().requires_grad_(True)
        acc_p, tfin_p, _ = plain(pg)
        obj = (acc_p * g_acc).sum() + (tfin_p * g_tfin).sum()
        plain_b_ms = cuda_ms(
            lambda: torch.autograd.grad(obj, [pg], retain_graph=True), 1, 0)
        del pg, acc_p, tfin_p, obj
        if lists is None:
            f_bytes, b_bytes = 40 * n + 24 * H * W, 80 * n + 28 * H * W
            note = ""
        else:
            entries = int(lists.seg_count.sum())
            tables = 8 * lists.seg_count.shape[0]
            f_bytes = 40 * n + 4 * entries + tables + 24 * H * W
            b_bytes = 80 * n + 4 * entries + tables + 28 * H * W
            note = f" [{backend}, {entries} list entries]"
        bf, byf = bound(f_bytes, pairs * K1_OPS_PER_PAIR)
        bb, byb = bound(b_bytes, pairs * K2_OPS_PER_PAIR)
        log(f"training shape {kind}{note}: {pairs} contributing (pixel, "
            f"splat) pairs; {kf} {f_ms:.4f} ms (plain fwd {plain_f_ms:.2f} "
            f"ms, bound {bf:.5f} ms by {byf}); {kb} {b_ms:.4f} ms (plain "
            f"bwd {plain_b_ms:.2f} ms, bound {bb:.5f} ms by {byb})")
        cu, mod, fl, bl = sources[kind]
        e_f, e_b = errs[kind]
        for name, line, ms, pms, bms, by, err, what in (
                (kf, fl, f_ms, plain_f_ms, bf, byf, e_f, "forward"),
                (kb, bl, b_ms, plain_b_ms, bb, byb, e_b, "backward")):
            rows.append(dict(
                name=f"{name} {kind} {what}", route="cuda",
                source=f"instantsplat_tpu_torch/csrc/{cu}",
                replaces=f"instantsplat_tpu/ops/{mod}:{line}",
                launches=path_launches[name], max_abs_err=err, ms=ms,
                plain_ms=pms, bound_ms=bms, bound_by=by, library_ms=None))
    profile_iterations(params, cam, dev)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
