#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stage 2 on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card and software: nvidia-smi name and power limit, torch/CUDA versions.
   Exits non-zero when torch.cuda.is_available() is false.
2. Build the CUDA kernels (K1 forward, K2 backward) from
   instantsplat_tpu_torch/csrc with nvcc for sm_90a; print ptxas's report.
3. Kernel against plain version at the golden-case shape (64x48, 400
   splats) and a ragged mid size (250x187, 20k splats): K1's acc and tfin
   within 5e-4, lc equal on >= 99.9% of pixels; K2's d(packed) within a
   relative L2 of 1e-3 (and elementwise at the golden case).
4. Train: a synthetic 3-view sparse_3 scene (COLMAP text, points3D.ply,
   PNG images; 100k points, 512x384) through
   instantsplat_tpu_torch.cli.train.main for 200 iterations with
   --pp_optimizer --optim_pose --sh_degree 3. The loss must fall and K1 and
   K2 must each launch once per iteration.
5. At the training shape, with the trained scene: K1/K2 against the plain
   version once more, their CUDA-event times, the plain version's times,
   and the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s fp32).

The last lines are one JSON object {"kernels": [...]}, the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_S = 67e12  # H100 SXM fp32 outside the tensor cores
# float operations per contributing (pixel, splat) pair, counted from
# csrc/rasterize.cu (each exp/log1p counted as one operation)
K1_OPS_PER_PAIR = 29
K2_OPS_PER_PAIR = 57
TRAIN_ITERS = 200
N_POINTS = 100_000
H, W = 384, 512


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


def plain_forward_backward(packed, g_acc, g_tfin, height, width):
    """Plain version's (acc, tfin, lc) and d(packed) for the cotangents."""
    import torch

    from instantsplat_tpu_torch.ops.rasterize import composite_plain

    p = packed.detach().clone().requires_grad_(True)
    acc, tfin, lc = composite_plain(p, height, width)
    (grad,) = torch.autograd.grad(
        (acc * g_acc).sum() + (tfin * g_tfin).sum(), [p])
    return acc.detach(), tfin.detach(), lc, grad


def kernel_forward_backward(packed, g_acc, g_tfin, height, width):
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP

    rect, batch = RP.splat_rects(packed, height, width)
    acc, tfin, lc = RP.k1_forward(packed, rect, batch, height, width)
    grad = RP.k2_backward(packed, rect, batch, g_acc, (g_tfin * tfin)
                          .contiguous(), tfin, lc)
    return acc, tfin, lc, grad


def compare(tag, packed, height, width, seed, elementwise):
    """Hold K1/K2 against the plain version on the same inputs; returns the
    max abs differences (K1 acc/tfin, K2 d(packed))."""
    import numpy as np
    import torch

    dev = packed.device
    rng = np.random.default_rng(seed)
    g_acc = torch.as_tensor(rng.normal(size=(4, height, width)),
                            dtype=torch.float32, device=dev)
    g_acc[3] *= 1e-2  # depth cotangent at a scale like the colors'
    g_tfin = torch.as_tensor(rng.normal(size=(height, width)),
                             dtype=torch.float32, device=dev)
    acc_p, tfin_p, lc_p, grad_p = plain_forward_backward(
        packed, g_acc, g_tfin, height, width)
    acc_k, tfin_k, lc_k, grad_k = kernel_forward_backward(
        packed, g_acc, g_tfin, height, width)
    torch.cuda.synchronize()
    e_acc = (acc_k - acc_p).abs().max().item()
    e_tfin = (tfin_k - tfin_p).abs().max().item()
    lc_eq = (lc_k.long() == lc_p).float().mean().item()
    rel_l2 = ((grad_k - grad_p).norm() / grad_p.norm().clamp(min=1e-30)
              ).item()
    e_grad = (grad_k - grad_p).abs().max().item()
    log(f"{tag}: N={packed.shape[0]} {width}x{height} K1 acc max|d|={e_acc:.3e}"
        f" tfin max|d|={e_tfin:.3e} lc equal={lc_eq * 100:.4f}% | K2 "
        f"d(packed) rel L2={rel_l2:.3e} max|d|={e_grad:.3e} "
        f"(max|ref|={grad_p.abs().max().item():.3e})")
    if not (e_acc <= 5e-4 and e_tfin <= 5e-4):
        fail(f"{tag}: K1 differs from the plain version beyond 5e-4")
    if lc_eq < 0.999:
        fail(f"{tag}: K1 last-contributor index equal on only "
             f"{lc_eq * 100:.3f}% of pixels (< 99.9%)")
    if not rel_l2 <= 1e-3:
        fail(f"{tag}: K2 gradient relative L2 {rel_l2:.3e} > 1e-3")
    if elementwise:
        # the JAX suite's kernel-vs-golden gradient tolerance
        # (tests/test_golden.py: rtol 5e-3, atol 1e-5)
        bad = (grad_k - grad_p).abs() > 1e-5 + 5e-3 * grad_p.abs()
        if bool(bad.any()):
            fail(f"{tag}: {int(bad.sum())} K2 gradient entries outside "
                 "rtol 5e-3 / atol 1e-5")
    return e_acc, e_grad


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


def main():
    import numpy as np
    import torch

    # ---- phase 1: card ---------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if not (REPO / "instantsplat_tpu_torch" / "csrc" / "rasterize.cu").is_file():
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
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP

    # ---- phase 2: build --------------------------------------------------
    t0 = time.time()
    lib = cuda_build.build("rasterize.cu")
    log(f"built {lib.relative_to(REPO)} in {time.time() - t0:.1f} s")
    for line in cuda_build.ptxas_report("rasterize.cu").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log(f"ptxas: {line.strip()}")

    # ---- phase 3: kernel against plain version ---------------------------
    compare("golden-case shape", blob_splats(400, 48, 64, 42, dev), 48, 64,
            seed=1, elementwise=True)
    compare("ragged mid size", blob_splats(20_000, 187, 250, 7, dev), 187,
            250, seed=2, elementwise=False)

    # ---- phase 4: train --------------------------------------------------
    from instantsplat_tpu_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory() as tmp:
        scene, out = Path(tmp) / "scene", Path(tmp) / "out"
        write_scene(scene)
        log(f"scene: {N_POINTS} points, 3 views {W}x{H}, PNG images")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        RP.K1.launches = RP.K2.launches = 0
        t_train = time.time()
        params, history = train_cli.main([
            "-s", str(scene), "-m", str(out), "--n_views", "3",
            "--iterations", str(TRAIN_ITERS), "--pp_optimizer",
            "--optim_pose", "--sh_degree", "3", "--log_every", "1",
            "--quiet"])
        torch.cuda.synchronize()
        t_train = time.time() - t_train
        launches = {"K1": RP.K1.launches, "K2": RP.K2.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for rel in ("point_cloud/iteration_200/point_cloud.ply",
                    "pose/ours_200/pose_optimized.npy", "cameras.json",
                    "cfg_args", "train_time.txt", "scalars.jsonl"):
            if not (out / rel).is_file():
                fail(f"training artifact missing: {rel}")
        from instantsplat_tpu_torch.data.scene import read_scene

        cam = read_scene(scene, 3, device=dev).cameras[0]
    losses = [m["loss"] for _, m in history]
    elapsed = {it: m["elapsed_s"] for it, m in history}
    steady_ms = (elapsed[TRAIN_ITERS] - elapsed[TRAIN_ITERS - 100]) * 10.0
    log(f"train: {len(history)} iterations in {t_train:.1f} s (scene read, "
        f"KNN and artifacts included); loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; steady {steady_ms:.2f} ms/iter over the last 100 "
        f"= {H * W / (steady_ms / 1e3) / 1e6:.2f} Mpix/s; launches {launches};"
        f" peak memory {peak_gb:.2f} GB")
    if len(history) != TRAIN_ITERS:
        fail(f"history has {len(history)} entries, expected {TRAIN_ITERS}")
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite loss")
    if not losses[-1] < losses[0]:
        fail("the loss did not fall")
    if launches != {"K1": TRAIN_ITERS, "K2": TRAIN_ITERS}:
        fail(f"kernel launches {launches} != {TRAIN_ITERS} each")

    # ---- phase 5: the training shape, trained scene ----------------------
    from instantsplat_tpu_torch.ops.losses import photometric_loss
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            params, params.get_pose(0), cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
            params.max_sh_degree, H, W)
    packed = packed.contiguous()
    e_acc, e_grad = compare("training shape", packed, H, W, seed=3,
                            elementwise=False)
    # real cotangents: the photometric loss of this view (black background)
    p = packed.clone().requires_grad_(True)
    acc, tfin = RP.composite_packed(p, H, W)
    rgb = acc[:3].permute(1, 2, 0) + tfin[:, :, None] * torch.zeros(3,
                                                                  device=dev)
    loss, _ = photometric_loss(rgb, cam.image)
    g_acc, g_tfin = torch.autograd.grad(loss, [acc, tfin])
    g_acc = g_acc.contiguous()
    rect, batch = RP.splat_rects(packed, H, W)
    acc_k, tfin_k, lc_k = RP.k1_forward(packed, rect, batch, H, W)
    gtu = (g_tfin * tfin_k).contiguous()
    k1_ms = cuda_ms(lambda: RP.k1_forward(packed, rect, batch, H, W), 20)
    k2_ms = cuda_ms(lambda: RP.k2_backward(packed, rect, batch, g_acc, gtu,
                                           tfin_k, lc_k), 20)
    from instantsplat_tpu_torch.ops.rasterize import composite_plain

    with torch.no_grad():
        plain_fwd_ms = cuda_ms(lambda: composite_plain(packed, H, W), 1, 1)
    pg = packed.clone().requires_grad_(True)
    acc_p, tfin_p, _ = composite_plain(pg, H, W)
    obj = (acc_p * g_acc).sum() + (tfin_p * g_tfin).sum()
    plain_bwd_ms = cuda_ms(
        lambda: torch.autograd.grad(obj, [pg], retain_graph=True), 1, 0)
    pairs = contributing_pairs(packed, H, W)
    n = packed.shape[0]
    k1_bytes, k2_bytes = 40 * n + 24 * H * W, 80 * n + 28 * H * W

    def bound(nbytes, ops):
        t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    b1, by1 = bound(k1_bytes, pairs * K1_OPS_PER_PAIR)
    b2, by2 = bound(k2_bytes, pairs * K2_OPS_PER_PAIR)
    log(f"training shape: {pairs} contributing (pixel, splat) pairs; K1 "
        f"{k1_ms:.4f} ms (plain fwd {plain_fwd_ms:.2f} ms, bound {b1:.5f} ms "
        f"by {by1}); K2 {k2_ms:.4f} ms (plain bwd {plain_bwd_ms:.2f} ms, "
        f"bound {b2:.5f} ms by {by2})")
    profile_iterations(params, cam, dev)
    kernels = [
        dict(name="K1 dense forward", route="cuda",
             source="instantsplat_tpu_torch/csrc/rasterize.cu",
             replaces="instantsplat_tpu/ops/rasterize_pallas.py:145",
             launches=launches["K1"], max_abs_err=e_acc, ms=k1_ms,
             plain_ms=plain_fwd_ms, bound_ms=b1, bound_by=by1,
             library_ms=None),
        dict(name="K2 dense backward", route="cuda",
             source="instantsplat_tpu_torch/csrc/rasterize.cu",
             replaces="instantsplat_tpu/ops/rasterize_pallas.py:265",
             launches=launches["K2"], max_abs_err=e_grad, ms=k2_ms,
             plain_ms=plain_bwd_ms, bound_ms=b2, bound_by=by2,
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
