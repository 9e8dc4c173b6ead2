#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stages 2, 3 and 5 on one NVIDIA card and
check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Card and software: nvidia-smi name and power limit, torch/CUDA versions.
   Exits non-zero when torch.cuda.is_available() is false.
2. Build the CUDA kernels from instantsplat_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc per source, started together: rasterize.cu (KR, the
   rectangle pass k1_rects; K1 dense forward; K2 dense backward) and
   rasterize_lists.cu (K3/K4 binned, K5/K6 tiled), which share
   compositor.cuh; print ptxas's report.
3. Kernel against plain version at the golden-case shape (64x48, 400
   splats) and a ragged mid size (250x187, 20k splats), for the dense
   kernels and for the binned and tiled ones at capacities sized for the
   splats, plus one deliberately overflowing capacity string each (kernel
   and plain version walk the same lists, so they drop the same pairs):
   acc and tfin within 5e-4, lc equal on >= 99.9% of pixels, d(packed)
   within a relative L2 of 1e-3 (and elementwise at the golden case). KR
   against its plain version: rectangles equal (a differing
   one is counted and printed, and may differ by one step of rounding
   only; K1's parity then shows it still covers every contributor), the
   coarse mask exactly the plain mask of the kernel's rectangles. Two more
   scenes for all six compositors: 20k splats on twelve tiles, so that
   every tile's queue overflows its capacity several times and every
   segment's list is several scan passes long, and opaque splats in front,
   so that whole tiles and spans hit the stop.
4. Train: a synthetic sparse_3 scene (COLMAP text, points3D.ply, PNG
   images; 100k points, three 512x384 train views of 15 frames; the test
   split and the ground truth are for phase 6) through
   instantsplat_tpu_torch.cli.train.main for 200 iterations with
   --pp_optimizer --optim_pose --sh_degree 3, four times:
   --backend pallas (KR, K1 and K2 launch once per iteration), --backend auto
   (prints which backend won; forward launches over K1/K3/K5 sum to 200),
   pallas-tiled:CF:DY:DX and pallas-binned:CF:DL sized by the port's
   tiled_/binned_view_requirements with headroom for the run: the larger
   of the requirement on the initial scene and on the dense run's final
   one (this scene's splats grow ~5x in 200 iterations), plus a margin.
   K5 and K6, or K3 and K4, launch 200 times each, and so does KR, which
   runs in front of them too; a demotion by the overflow guard fails the
   run. A second dense run measures the
   run-to-run spread. Every loss must fall and each curve must stay within
   LOSS_RTOL of the dense run's.
5. At the training shape, with the trained scene: each kernel against the
   plain version once more, the kernels' times (20 launches replayed from
   a CUDA graph, which is the device's time, and CUDA events around eager
   launches, which read the host's pace when the host is the slower), the
   plain version's times, and the least time the card could take (bytes over
   3.35 TB/s, operations over 67 TFLOP/s fp32). For the dense pair also:
   rectangle tests per launch (tiles x N without the coarse mask, 32 per
   marked (group, tile) with it), evaluated against contributing pairs
   (every pixel of a covered tile, or only the 8x4 blocks a queued splat's
   block mask marks), KR's time (CUDA events, which include the host's
   launch cost, and a CUDA-graph replay, which does not) beside the plain
   rectangles' on the card. For the binned and the tiled pair: list
   entries, rectangle tests and fetched rows per launch, evaluated against
   contributing pairs before (every pixel of a segment walks its whole
   list) and after (the 8x4 blocks a fetched entry's block mask marks), and
   the first design's times beside the new ones. Then 10 iterations of the
   dense, the binned and the tiled path under torch.profiler.
6. Stages 3 and 5 on the model of phase 4's first dense run, through
   instantsplat_tpu_torch.cli.render.main and cli.metrics.main: the train
   views; N_TEST_VIEWS test views, each refined from a start 2 degrees and
   0.1 off its true pose by 500 Adam steps through KR, K1 and K2 with the
   Gaussians frozen (each view's best loss must fall below its start loss
   and its pose come nearer the truth), then rendered; the FPS benchmark;
   the interpolated path with --backend auto; results.json (finite PSNR,
   SSIM and ATE, LPIPS null). Launch counts of KR, K1 and K2 must equal
   the renders and refinement steps. 20 refinement steps under
   torch.profiler (the card's busy share of a step). Then the refiner on
   the card against the CPU (10 steps on a small view, pose within 1e-5)
   and LPIPS with random weights on a 512x384 pair, card against CPU
   (relative 1e-4: full float32, no TF32). Prints ms per refinement
   iteration, seconds per view, FPS, ms per interpolated frame and the
   metrics stage's seconds beside the card's name and power limit.

The last lines are one JSON object {"kernels": [...]} with seven entries,
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
# float operations per contributing (pixel, splat) pair, counted from the
# walks of csrc/compositor.cuh (each exp/log1p counted as one operation),
# which the dense and the list kernels share: K3/K5 count as K1 and K4/K6
# as K2
K1_OPS_PER_PAIR = 29
K2_OPS_PER_PAIR = 57
# float operations per splat in k1_rects (radius, four floors)
KR_OPS_PER_SPLAT = 35
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
# The dataset of phases 4 and 6: 15 frames along an arc, in name order.
# split_train_test(15 names, 3 views) makes frames 0, 12 and 14 the train
# views (at -0.15, 0 and 0.15 rad, which phase 4 trains on) and the other
# twelve test views; N_TEST_VIEWS of them, spread evenly, are in sparse_3/1
FRAME_ANGLES = tuple([-0.15 + 0.15 * k / 12 for k in range(12)]
                     + [0.0, 0.075, 0.15])
TRAIN_FRAMES = (0, 12, 14)
N_TEST_VIEWS = 12
REFINE_ITERS = 500  # the reference's test-time pose refinement
FPS_RENDERS = 1000  # renders of the --test_fps benchmark (plus a warm one)
# start poses of the test views: turned 2 degrees about a random axis and
# moved 0.1 (the cameras stand 4 from the surface) in a random direction
PERTURB_RAD = math.radians(2.0)
PERTURB_T = 0.1
# relative difference of LPIPS on the card and on the CPU (TF32 would give
# ~1e-3)
LPIPS_RTOL = 1e-4
# CUDA-event ms of the list kernels' first design (every pixel of a CTA
# walked its segment's whole list; scalar atomics in the backward) at the
# training shape on an NVIDIA H100 80GB HBM3 at 700 W, printed beside this
# run's times
FIRST_DESIGN_MS = {"K3": 1.4631, "K4": 1.6989, "K5": 0.6264, "K6": 0.9697}
# list entries one scan pass of K3-K6 takes (csrc/rasterize_lists.cu PASS)
LIST_PASS = 1024


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


def ray_cast(w2c, fx):
    """[H, W, 3] image of the textured relief surface seen by `w2c`."""
    import numpy as np

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c2w = np.linalg.inv(w2c)
    d = np.stack([(gx - (W - 1) / 2) / fx, (gy - (H - 1) / 2) / fx,
                  np.ones_like(gx, np.float64)], -1) @ c2w[:3, :3].T
    o = c2w[:3, 3]
    t = -o[2] / d[..., 2]  # plane z = 0, then fixed-point refinement
    for _ in range(8):
        p = o + t[..., None] * d
        t = (surface(p[..., 0], p[..., 1]) - o[2]) / d[..., 2]
    p = o + t[..., None] * d
    return texture(p[..., 0], p[..., 1])


def perturbed(w2c, rng):
    """`w2c` turned by PERTURB_RAD about a random axis and moved by
    PERTURB_T in a random direction."""
    import numpy as np

    from instantsplat_tpu_torch.utils import transforms as T

    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    half = PERTURB_RAD / 2
    turn = T.qvec_to_rotmat(np.concatenate([[np.cos(half)],
                                            np.sin(half) * axis]))
    shift = rng.normal(size=3)
    out = np.array(w2c, np.float64)
    out[:3, :3] = turn @ out[:3, :3]
    out[:3, 3] = turn @ out[:3, 3] + PERTURB_T * shift / np.linalg.norm(
        shift)
    return out


def write_scene(root: Path, seed: int = 0):
    """sparse_3 scene of a textured relief surface: its colored point cloud
    (sparse_3/0/points3D.ply), 15 PNG frames along an arc ray-cast from the
    surface, the three train views (sparse_3/0), N_TEST_VIEWS test views
    whose start poses are perturbed from the truth (sparse_3/1), and the
    dataset's ground truth of all 15 frames (sparse/0)."""
    import numpy as np

    from instantsplat_tpu_torch.data import colmap, png, ply

    rng = np.random.default_rng(seed)
    fx = 0.9 * W
    xy = rng.uniform([-3.0, -2.2], [3.0, 2.2], size=(N_POINTS, 2))
    pts = np.concatenate([xy, surface(xy[:, 0], xy[:, 1])[:, None]], 1)
    cols = texture(xy[:, 0], xy[:, 1])
    for sub in ("sparse_3/0", "sparse_3/1", "sparse/0"):
        (root / sub).mkdir(parents=True)
    (root / "images").mkdir()
    ply.store_point_cloud(root / "sparse_3/0/points3D.ply", pts,
                          cols * 255.0)
    test_frames = [k for k in range(len(FRAME_ANGLES))
                   if k not in TRAIN_FRAMES]
    test_frames = [test_frames[i] for i in np.linspace(
        0, len(test_frames) - 1, N_TEST_VIEWS).round().astype(int)]
    splits = {"sparse_3/0": ({}, {}), "sparse_3/1": ({}, {}),
              "sparse/0": ({}, {})}
    jitter = np.random.default_rng(seed + 1)
    for k, ang in enumerate(FRAME_ANGLES):
        w2c = look_at_w2c((4.0 * np.sin(ang), 0.3, -4.0 * np.cos(ang)))
        name = f"{k:03d}.png"
        png.write_png(root / "images" / name, np.clip(
            ray_cast(w2c, fx) * 255.0 + 0.5, 0, 255).astype(np.uint8))
        subs = ["sparse/0"] + (["sparse_3/0"] if k in TRAIN_FRAMES else
                               ["sparse_3/1"] if k in test_frames else [])
        for sub in subs:
            pose = perturbed(w2c, jitter) if sub == "sparse_3/1" else w2c
            cams, ims = splits[sub]
            i = len(cams) + 1
            cams[i] = colmap.ColmapCamera(i, "PINHOLE", W, H,
                                          np.array([fx, fx, W / 2, H / 2]))
            ims[i] = colmap.ColmapImage(
                i, colmap.rotmat_to_qvec(pose[:3, :3]), pose[:3, 3], i, name)
    for sub, (cams, ims) in splits.items():
        colmap.write_cameras_text(cams, root / sub / "cameras.txt")
        colmap.write_images_text(ims, root / sub / "images.txt")


# --------------------------------------------------------------------------
# kernel against plain version
# --------------------------------------------------------------------------


def backend_paths(backend: str, packed, height, width):
    """(kernel names, plain(p) -> (acc, tfin, lc), kernel fwd(), kernel
    bwd(g_acc, gtu, tfin, lc), (lists, geometry, pixels per CTA row) or
    None) for the dense backend "pallas" or a capacity backend string; the
    list backends build their lists once, so the kernel and the plain
    version walk the same ones. KR's rectangles are made once, outside the
    kernels' timed calls."""
    from instantsplat_tpu_torch.ops import rasterize_lists as RL
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
    from instantsplat_tpu_torch.ops.rasterize import composite_plain
    from instantsplat_tpu_torch.render import driver

    scan = RP.k1_rects(packed, height, width)
    if backend == "pallas":
        return (("K1", "K2"),
                lambda p: composite_plain(p, height, width),
                lambda: RP.k1_forward(packed, scan, height, width),
                lambda ga, gtu, tf, lc: RP.k2_backward(packed, scan, ga, gtu,
                                                       tf, lc),
                None)
    if backend.startswith("pallas-binned"):
        lists, geom = RB.bin_lists(packed, height, width,
                                   *driver._parse_binned_caps(backend))
        names, fwd, bwd, cta_cols = ("K3", "K4"), RB.K3, RB.K4, RB.CTA_COLS
    else:
        lists, geom = RT.tile_lists(packed, height, width,
                                    *driver._parse_tiled_caps(backend))
        names, fwd, bwd, cta_cols = ("K5", "K6"), RT.K5, RT.K6, RT.CTA_COLS
    return (names,
            lambda p: RL.composite_lists_plain(p, lists, geom, height, width),
            lambda: RL.lists_forward(fwd, packed, scan.rect, lists, geom,
                                     height, width),
            lambda ga, gtu, tf, lc: RL.lists_backward(
                bwd, packed, scan.rect, lists, geom, ga, gtu, tf, lc),
            (lists, geom, cta_cols))


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
    (kf, kb), plain, k_fwd, k_bwd, listed = backend_paths(
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
    lists_note = "" if listed is None else (
        f" [{backend}: overflow={bool(listed[0].overflow)}, "
        f"{int(listed[0].seg_count.sum())} list entries, longest list "
        f"{int(listed[0].seg_count.max())}]")
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


def compare_rects(tag, packed, height, width):
    """Hold KR (k1_rects) against its plain version. -> (the kernel's
    DenseScan, max abs difference of a rectangle entry, entries of the
    longest tile queue)."""
    import torch

    from instantsplat_tpu_torch.ops import rasterize_pallas as RP

    scan = RP.k1_rects(packed, height, width)
    torch.cuda.synchronize()
    plain = RP.scan_plain(packed, height, width)
    d_rect = (scan.rect.int() - plain.rect.int()).abs()
    n_rect = int((d_rect > 0).any(1).sum())
    err = int(d_rect.max()) if len(d_rect) else 0
    mask_of_kernel_rects = RP.group_tile_mask(RP.unpack_rects(scan.rect),
                                              height, width)
    mask_eq = torch.equal(scan.mask, mask_of_kernel_rects)
    _, cx, cy = RP.covered_tiles(RP.unpack_rects(scan.rect), height, width)
    longest = int(torch.bincount(cy * -(-width // RP.TILE) + cx).max()) \
        if len(cx) else 0
    log(f"{tag}: KR N={packed.shape[0]} {width}x{height}: {n_rect} "
        f"rectangles differ from the plain version (max step {err}); "
        f"coarse mask equal to the plain mask of the "
        f"kernel's rectangles: {mask_eq}, to the plain version's: "
        f"{torch.equal(scan.mask, plain.mask)}; longest tile queue "
        f"{longest} entries (K1/K2 hold {RP.QUEUE_CAP} at a time)")
    if not mask_eq:
        fail(f"{tag}: KR's coarse mask does not match its rectangles")
    if err > 1 or n_rect > max(1, packed.shape[0] // 1000):
        fail(f"{tag}: KR differs from the plain version beyond one "
             f"rounding step on a few splats ({n_rect}, max step {err})")
    return scan, float(err), longest


def opaque_front(packed, height, width, seed):
    """`packed` with 40 large, nearly opaque splats put in front of the
    left half of the image: every pixel of the tiles there hits the
    latched stop within a few splats, the right half composites as
    before."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    k = 40
    front = np.zeros((k, 10), np.float32)
    front[:, 0] = rng.uniform(0, width / 2, k)
    front[:, 1] = rng.uniform(0, height, k)
    sigma = 0.2 * max(height, width)
    front[:, 2] = front[:, 4] = 1.0 / sigma ** 2
    front[:, 5] = np.log(0.999)
    front[:, 6:9] = rng.uniform(size=(k, 3))
    front[:, 9] = np.sort(rng.uniform(0.01, 0.02, k))
    return torch.cat([torch.as_tensor(front, device=packed.device),
                      packed]).contiguous()


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
    errs = {"rects": compare_rects(tag, packed, height, width)[1:],
            "dense": compare(tag, packed, height, width, seed, elementwise)}
    for kind, backend in sized_backends(packed, height, width).items():
        errs[kind] = compare(tag, packed, height, width, seed, elementwise,
                             backend)
    if overflow:
        for kind, backend in OVERFLOW.items():
            lists = backend_paths(backend, packed, height, width)[4][0]
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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of `fn`: `reps` calls captured in a CUDA
    graph and replayed, so the host's launch cost stays out (for a kernel
    shorter than its launch)."""
    import torch

    # `fn` runs on a stream of its own: what made its inputs, on the
    # current stream, must have finished
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, 5) / reps


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


def profile_window(tag, backend, run, iters: int, top: int):
    """torch.profiler over run(), which takes `iters` steps and ends
    synchronised: device time per step by kernel name, and the share of
    the window's wall time the card was busy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not by_name:
        log(f"profile {tag}: torch.profiler recorded no device events")
        return
    log(f"profile {tag} ({backend}): {iters} iterations, "
        f"{wall_ms / iters:.2f} ms/iter wall "
        f"(profiler on), device busy {busy_ms / iters:.2f} ms/iter = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%)"
        f", {len(by_name)} kernel names")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"profile {tag}: {ms / iters:8.3f} ms/iter "
            f"{100 * ms / busy_ms:5.1f}% {name[:110]}")


def profile_iterations(tag, params, cam, dev, backend="auto", top=12,
                       iters: int = 10):
    """profile_window over `iters` steady steps of the training step on
    one view with `backend`."""
    import torch

    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step
    from instantsplat_tpu_torch.render import driver

    driver._guard = driver._OverflowGuard()  # nothing checked or demoted
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True),
                            total_iterations=TRAIN_ITERS)
    state = opt.init(params)
    bg = torch.zeros(3, device=dev)

    def step(i):
        float(train_step(params, cam, opt, state, i, 0, bg, 0.2, backend,
                         256)["loss"])  # per-iteration loss read, as trained

    for i in range(3):
        step(i + 1)
    profile_window(tag, backend, lambda: [step(i + 4) for i in range(iters)],
                   iters, top)


def kernel_table():
    """{name: Kernel} of the seven kernels, in order."""
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT

    return {"KR": RP.KR, "K1": RP.K1, "K2": RP.K2, "K3": RB.K3, "K4": RB.K4,
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


def run_cli(main, argv):
    """Run a CLI main with the launch counts set to 0 just before and read
    just after, each run with no capacity signature checked or demoted.
    -> (what main returned, its stdout, seconds, launches {KR, K1..K6},
    the overflow guard's demotion warnings)."""
    import contextlib

    import torch

    from instantsplat_tpu_torch.render import driver

    driver._guard = driver._OverflowGuard()
    kernels = kernel_table()
    warns = _Warnings()
    guard_log = logging.getLogger("instantsplat_tpu_torch.render.driver")
    guard_log.addHandler(warns)
    tee = _Tee(sys.stdout)
    try:
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            result = main([str(a) for a in argv])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        guard_log.removeHandler(warns)
    return result, "".join(tee.text), seconds, launches, warns.messages


def train_run(scene: Path, out: Path, backend: str, log_every: int):
    """One 200-iteration training run through the CLI. -> (params,
    history, launches {KR, K1..K6}, seconds, the trainer's "backend auto"
    lines, the overflow guard's demotion warnings)."""
    from instantsplat_tpu_torch.cli import train as train_cli

    (params, history), text, seconds, launches, demotions = run_cli(
        train_cli.main, [
            "-s", scene, "-m", out, "--n_views", 3, "--iterations",
            TRAIN_ITERS, "--pp_optimizer", "--optim_pose", "--sh_degree", 3,
            "--log_every", log_every, "--backend", backend, "--quiet"])
    auto_lines = [ln for ln in text.splitlines() if "backend auto" in ln]
    return params, history, launches, seconds, auto_lines, demotions


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


def training_shape(params, cam, dev, path_launches):
    """Phase 5: each kernel against the plain version at the training
    shape, its times and bound, then the profiled iterations. -> the
    kernels' JSON rows."""
    import numpy as np
    import torch

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

    # the dense pair's scan: what the coarse mask and the row spans save
    from instantsplat_tpu_torch.ops import rasterize_lists as RL
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP

    scan = RP.k1_rects(packed, H, W)
    n_tiles = -(-W // RP.TILE) * -(-H // RP.TILE)
    tests, covered, evaluated = RP.scan_counts(packed, scan, H, W)
    log(f"training shape dense scan: rectangle tests per launch "
        f"{n_tiles * n} (tiles x N) -> {tests} (32 per marked (group, "
        f"tile)); {covered} queue entries (covered (splat, tile) pairs) = "
        f"{covered / n_tiles:.1f} splats a tile; evaluated (pixel, splat) "
        f"pairs {covered * RP.TILE ** 2} (every pixel of a covered tile) "
        f"-> {evaluated} (the 8x4 blocks the block masks mark) for {pairs} "
        f"contributing = {evaluated / pairs:.2f}x")
    kr_ms = graph_ms(lambda: RP.k1_rects(packed, H, W), 20)
    kr_events_ms = cuda_ms(lambda: RP.k1_rects(packed, H, W), 20)
    rects_plain_ms = cuda_ms(lambda: RP.splat_rects(packed, H, W), 20)
    scan_plain_ms = cuda_ms(lambda: RP.scan_plain(packed, H, W), 3, 1)
    kr_bytes = 24 * n + 8 * n + 4 * scan.mask.numel()
    kr_bound, kr_by = bound(kr_bytes, n * KR_OPS_PER_SPLAT)
    log(f"training shape KR: {kr_ms:.4f} ms in a CUDA-graph replay, "
        f"{kr_events_ms:.4f} ms by CUDA events around eager launches (host "
        f"launch cost included); plain splat_rects on the card "
        f"{rects_plain_ms:.4f} ms, plain rectangles + coarse mask "
        f"{scan_plain_ms:.2f} ms; bound {kr_bound:.5f} ms by {kr_by}")
    rows = [dict(
        name="KR dense rectangles", route="cuda",
        source="instantsplat_tpu_torch/csrc/rasterize.cu",
        replaces="instantsplat_tpu/ops/rasterize_pallas.py:408",
        launches=path_launches["KR"], max_abs_err=errs["rects"][0],
        ms=kr_ms, plain_ms=scan_plain_ms, bound_ms=kr_bound, bound_by=kr_by,
        library_ms=None)]
    sources = {"dense": ("rasterize.cu", "rasterize_pallas.py", 145, 265),
               "binned": ("rasterize_lists.cu", "rasterize_pallas_binned.py",
                          202, 270),
               "tiled": ("rasterize_lists.cu", "rasterize_pallas_tiled.py",
                         218, 291)}
    for kind in ("dense", "binned", "tiled"):
        backend = "pallas" if kind == "dense" else sized[kind]
        (kf, kb), plain, k_fwd, k_bwd, listed = backend_paths(
            backend, packed, H, W)
        acc_k, tfin_k, lc_k = k_fwd()
        gtu = (g_tfin * tfin_k).contiguous()
        # device time: 20 launches replayed from a CUDA graph (events
        # around eager launches read the host's pace when the host is
        # slower than the kernel; they are logged beside)
        f_ms = graph_ms(k_fwd, 20)
        b_ms = graph_ms(lambda: k_bwd(g_acc, gtu, tfin_k, lc_k), 20)
        f_events_ms = cuda_ms(k_fwd, 20)
        b_events_ms = cuda_ms(lambda: k_bwd(g_acc, gtu, tfin_k, lc_k), 20)
        with torch.no_grad():
            plain_f_ms = cuda_ms(lambda: plain(packed), 1, 1)
        pg = packed.clone().requires_grad_(True)
        acc_p, tfin_p, _ = plain(pg)
        obj = (acc_p * g_acc).sum() + (tfin_p * g_tfin).sum()
        plain_b_ms = cuda_ms(
            lambda: torch.autograd.grad(obj, [pg], retain_graph=True), 1, 0)
        del pg, acc_p, tfin_p, obj
        if listed is None:
            scan_bytes = 8 * n + 4 * scan.mask.numel()
            f_bytes = 40 * n + scan_bytes + 24 * H * W
            b_bytes = 80 * n + scan_bytes + 28 * H * W
            note = ""
        else:
            lists, geom, cta_cols = listed
            counts = RL.list_counts(packed, lists, geom, cta_cols, H, W)
            tables = 8 * lists.seg_count.shape[0]
            # the rectangles (8 B a splat) are read too since the redesign
            f_bytes = 48 * n + 4 * counts.entries + tables + 24 * H * W
            b_bytes = 88 * n + 4 * counts.entries + tables + 28 * H * W
            note = f" [{backend}, {counts.entries} list entries]"
            log(f"training shape {kind} lists: {counts.entries} list "
                f"entries = {counts.entries / n:.2f} a splat, "
                f"{counts.entries / geom.n_seg:.0f} a segment (longest "
                f"{int(lists.seg_count.max())}); rectangle tests per launch "
                f"{counts.tests} (one per entry and {geom.seg_rows}x"
                f"{cta_cols} CTA of its segment), rows fetched "
                f"{counts.queued}; evaluated (pixel, entry) pairs "
                f"{counts.pairs_before} (every pixel of a segment walks its "
                f"whole list) = {counts.pairs_before / pairs:.2f}x the "
                f"{pairs} contributing -> {counts.pairs_after} (the 8x4 "
                f"blocks the block masks mark) = "
                f"{counts.pairs_after / pairs:.2f}x")
            log(f"training shape {kind}: first design {kf} "
                f"{FIRST_DESIGN_MS[kf]:.4f} ms, {kb} "
                f"{FIRST_DESIGN_MS[kb]:.4f} ms (NVIDIA H100 80GB HBM3, 700 "
                f"W, by CUDA events) -> this run {kf} {f_events_ms:.4f} ms "
                f"by events = {FIRST_DESIGN_MS[kf] / f_events_ms:.2f}x, "
                f"{kb} {b_events_ms:.4f} ms = "
                f"{FIRST_DESIGN_MS[kb] / b_events_ms:.2f}x")
        bf, byf = bound(f_bytes, pairs * K1_OPS_PER_PAIR)
        bb, byb = bound(b_bytes, pairs * K2_OPS_PER_PAIR)
        log(f"training shape {kind}{note}: {pairs} contributing (pixel, "
            f"splat) pairs; {kf} {f_ms:.4f} ms in a CUDA-graph replay, "
            f"{f_events_ms:.4f} ms by CUDA events around eager launches "
            f"(plain fwd {plain_f_ms:.2f} ms, bound {bf:.5f} ms by {byf}); "
            f"{kb} {b_ms:.4f} ms in a replay, {b_events_ms:.4f} ms by "
            f"events (plain bwd {plain_b_ms:.2f} ms, bound {bb:.5f} ms by "
            f"{byb})")
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
    profile_iterations("dense", params, cam, dev)
    # the capacity paths, sized for the scene as it now stands (the
    # profiled steps go on training it)
    for kind, backend in sized_backends(packed, H, W, (1, 2, 1)).items():
        forward = kernel_table()[{"binned": "K3", "tiled": "K5"}[kind]]
        before = forward.launches
        profile_iterations(kind, params, cam, dev, backend, top=5)
        if forward.launches == before:
            fail(f"profile {kind}: {backend} never launched {forward.name}")
    return rows


def pose_error(w2c, gt_c2w) -> float:
    """How far a w2c pose is from the truth: the distance of its camera
    centre plus the arc its view direction sweeps at the surface's
    distance (4 x the rotation angle)."""
    import numpy as np

    c2w = np.linalg.inv(w2c)
    cos = (np.trace(c2w[:3, :3].T @ gt_c2w[:3, :3]) - 1.0) / 2.0
    return float(np.linalg.norm(c2w[:3, 3] - gt_c2w[:3, 3])
                 + 4.0 * np.arccos(np.clip(cos, -1.0, 1.0)))


def refine_case(device):
    """A small refinement case: 500 seeded Gaussians, a 64x48 view whose
    ground truth is the plain render at its own pose, and a start moved
    from it. -> (gaussians, camera with its image, start pose7)."""
    import numpy as np
    import torch

    from instantsplat_tpu_torch.models.camera import Camera
    from instantsplat_tpu_torch.models.gaussians import (PARAM_FIELDS,
                                                         GaussianModel)
    from instantsplat_tpu_torch.render.driver import render
    from instantsplat_tpu_torch.utils import transforms as T

    rng = np.random.default_rng(12)
    n = 500
    g = GaussianModel.create_from_pcd(
        rng.normal(size=(n, 3)) * [1.0, 0.8, 0.3],
        rng.uniform(0.05, 0.95, (n, 3)), cam_poses=np.zeros((1, 7)),
        max_sh_degree=1, device="cpu")
    g.scaling += torch.as_tensor(rng.normal(size=(n, 3)) * 0.3,
                                 dtype=torch.float32)
    g.opacity = torch.as_tensor(rng.normal(size=(n, 1)) + 1.0,
                                dtype=torch.float32)
    g.rotation = torch.as_tensor(rng.normal(size=(n, 4)), dtype=torch.float32)
    M = look_at_w2c((0.5, 0.3, -4.0))
    with torch.no_grad():
        gt = render(g, Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0,
                                     height=48, width=64, device="cpu"),
                    backend="oracle").render.numpy()
    g = type(g)(**{f: getattr(g, f).to(device) for f in PARAM_FIELDS},
                max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=48,
                        width=64, image=gt, device=device)
    return g, cam, T.matrix_to_pose_np(perturbed(M, rng))


def stages_3_and_5(scene: Path, model: Path, dev, smi: str):
    """Phase 6: the render stage with test-time pose refinement, the
    interpolated path and the metrics stage, through their CLIs, on the
    dense run's model; then the refiner and LPIPS on the card against the
    CPU."""
    import re

    import numpy as np
    import torch

    from instantsplat_tpu_torch.cli import metrics as metrics_cli
    from instantsplat_tpu_torch.cli import render as render_cli
    from instantsplat_tpu_torch.data.images import load_image
    from instantsplat_tpu_torch.data.scene import (read_colmap_gt_pose,
                                                   read_scene)
    from instantsplat_tpu_torch.eval.image_metrics import LpipsVGG, lpips
    from instantsplat_tpu_torch.ops.losses import masked_l1_loss
    from instantsplat_tpu_torch.pipelines.render_pipeline import (
        make_pose_refiner)
    from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
    from instantsplat_tpu_torch.render.driver import render
    from instantsplat_tpu_torch.utils import transforms as T

    it = TRAIN_ITERS
    test = read_scene(scene, 3, split="test", device=dev)
    v = len(test.cameras)
    gt_c2w = read_colmap_gt_pose(scene)
    frames = [int(name[:3]) for name in test.image_names]
    # the loss at each start pose: the first refinement step's
    params, _ = load_trained(model, it, device=dev)
    with torch.no_grad():
        start_loss = []
        for cam in test.cameras:
            out = render(params, cam, backend="pallas")
            start_loss.append(float(masked_l1_loss(out.render, cam.image,
                                                   out.render > 0.0)))
    del params

    # ---- stage 3: train and test views, refinement, FPS ----
    _, text, secs, launches, dem = run_cli(render_cli.main, [
        "-s", scene, "-m", model, "--backend", "pallas", "--test_fps",
        "--optim_test_pose_iter", REFINE_ITERS])
    for msg in dem:
        log(f"render: overflow guard: {msg}")
    views = re.findall(
        r"\[render\] pose refinement view (\d+)/\d+: (\d+) iterations in "
        r"([\d.]+) s, best masked L1 (\S+), pose ([^\n]+)", text)
    if len(views) != v:
        fail(f"render: {len(views)} refinement lines for {v} test views")
    view_s = []
    for i, (_, n_it, sec, best, pose) in enumerate(views):
        pose = np.array([float(x) for x in pose.split()])
        gt = gt_c2w[frames[i]]
        e0 = pose_error(test.poses_w2c[i], gt)
        e1 = pose_error(T.pose_to_matrix_np(pose), gt)
        view_s.append(float(sec))
        log(f"render: test view {i + 1}/{v} (frame {frames[i]}): masked L1 "
            f"{start_loss[i]:.6f} -> {float(best):.6f}, distance from the "
            f"true pose {e0:.5f} -> {e1:.5f} ({n_it} iterations, "
            f"{float(sec):.2f} s)")
        if not float(best) < start_loss[i]:
            fail(f"render: view {i + 1}: the best loss {best} is not below "
                 f"the start loss {start_loss[i]:.6f}")
        if not e1 < e0:
            fail(f"render: view {i + 1}: the refined pose ({e1:.5f}) is not "
                 f"nearer the truth than the start ({e0:.5f})")
    fps = json.loads((model / "total_fps.json").read_text().splitlines()[-1])
    out = model / "test" / f"ours_{it}"
    counts = {rel: len(list((model / rel).glob("*.png"))) for rel in (
        f"train/ours_{it}/renders", f"test/ours_{it}/renders",
        f"test/ours_{it}/gt")}
    if counts != {f"train/ours_{it}/renders": 3, f"test/ours_{it}/renders": v,
                  f"test/ours_{it}/gt": v}:
        fail(f"render: PNG counts {counts}")
    fwd = 3 + v * REFINE_ITERS + v + FPS_RENDERS + 1
    want = {"KR": fwd, "K1": fwd, "K2": v * REFINE_ITERS, "K3": 0, "K4": 0,
            "K5": 0, "K6": 0}
    log(f"render: launches {launches} (expected {want}: 3 train renders, "
        f"{v} x {REFINE_ITERS} refinement steps, {v} test renders, "
        f"{FPS_RENDERS + 1} FPS renders)")
    if launches != want:
        fail(f"render: kernel launches {launches} != {want}")
    ms_iter = 1e3 * sum(view_s) / (v * REFINE_ITERS)
    log(f"render [{smi}]: {secs:.1f} s for the stage ({v} test views); "
        f"refinement {ms_iter:.2f} ms per iteration, "
        f"{sum(view_s) / v:.2f} s per view ({min(view_s):.2f}-"
        f"{max(view_s):.2f}); FPS {float(fps):.1f} (mean of the middle "
        f"{FPS_RENDERS * 8 // 10} of {FPS_RENDERS} synchronised renders)")

    # ---- stage 3 again: the interpolated path, auto's pick ----
    _, text, secs, launches, dem = run_cli(render_cli.main, [
        "-s", scene, "-m", model, "--infer_video", "--skip_train"])
    for msg in dem:
        log(f"render video: overflow guard: {msg}")
    for line in text.splitlines():
        if "skipped" in line or "unavailable" in line:
            log(f"render video: {line.strip()}")
    inter = np.load(model / "pose" / f"ours_{it}" / "pose_interpolated.npy")
    n_frames = len(list((model / "interp" / f"ours_{it}" / "renders").glob(
        "*.png")))
    fwd = launches["K1"] + launches["K3"] + launches["K5"]
    bwd = launches["K2"] + launches["K4"] + launches["K6"]
    picked = ("dense" if launches["K1"] >= len(inter) else "tiled"
              if launches["K5"] >= len(inter) else "binned")
    log(f"render video [{smi}]: {n_frames} frames of a {len(inter)}-pose "
        f"path in {secs:.1f} s = {secs / n_frames * 1e3:.1f} ms a frame "
        f"(model load, auto's timed pick and PNG writes included); auto "
        f"rendered with {picked}; launches {launches}")
    if n_frames != len(inter) or len(inter) != 2 * (10 * 30 // 3) + 1:
        fail(f"render video: {n_frames} frames for {len(inter)} poses")
    # auto times one warm and one timed forward of dense and of the sized
    # candidate (if any); every forward launches KR in front
    if bwd or fwd - len(inter) not in (2, 4) or launches["KR"] != fwd:
        fail(f"render video: launches {launches} for {len(inter)} frames")

    # ---- stage 5 ----
    _, _, secs, _, _ = run_cli(metrics_cli.main, [
        "-m", model, "-s", scene, "--n_views", "3"])
    res = json.loads((model / "results.json").read_text())[f"ours_{it}"]
    log(f"metrics [{smi}]: {secs:.2f} s; results.json {res}")
    if not all(math.isfinite(res[k]) for k in ("PSNR", "SSIM", "ATE",
                                                "RPE_t", "RPE_r")):
        fail(f"metrics: non-finite value in {res}")
    if res["LPIPS"] is not None:
        fail("metrics: LPIPS is not null without weights")

    # ---- where a refinement step's time goes: 20 steps on view 1 ----
    params, _ = load_trained(model, it, device=dev)
    cam = test.cameras[0]
    pose0 = T.matrix_to_pose_np(test.poses_w2c[:1])[0]
    make_pose_refiner(params, cam, num_iter=3)(pose0, cam.image)  # warm
    refine = make_pose_refiner(params, cam, num_iter=20)
    profile_window("refine", "pallas", lambda: refine(pose0, cam.image), 20,
                   top=8)
    del params

    # ---- the refiner and LPIPS on the card against the CPU ----
    poses = {}
    for where in (dev, torch.device("cpu")):
        g, cam, pose0 = refine_case(where)
        pose, loss = make_pose_refiner(g, cam, num_iter=10)(pose0, cam.image)
        poses[where.type] = (pose.cpu().numpy(), float(loss))
    d_pose = float(np.abs(poses["cuda"][0] - poses["cpu"][0]).max())
    d_loss = abs(poses["cuda"][1] - poses["cpu"][1]) / poses["cpu"][1]
    log(f"refiner, 10 steps at 64x48, card against the CPU: pose max |d| "
        f"{d_pose:.3e} (limit 1e-5), best loss relative {d_loss:.3e} "
        f"(limit 1e-5)")
    if not (d_pose <= 1e-5 and d_loss <= 1e-5):
        fail("refiner: the card's result differs from the CPU's")
    x = load_image(out / "renders" / "00000.png")
    y = load_image(out / "gt" / "00000.png")
    vals = {}
    for where in (dev, torch.device("cpu")):
        vals[where.type] = float(lpips(torch.as_tensor(x, device=where),
                                       torch.as_tensor(y, device=where),
                                       LpipsVGG.random(0, device=where)))
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    log(f"LPIPS random(0) on a {W}x{H} pair: card {vals['cuda']:.7f}, CPU "
        f"{vals['cpu']:.7f}, relative {rel:.3e} (limit {LPIPS_RTOL:g})")
    if not rel <= LPIPS_RTOL:
        fail("LPIPS on the card differs from the CPU's (TF32?)")


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
    mid = blob_splats(20_000, 187, 250, 7, dev)
    compare_all("ragged mid size", mid, 187, 250, seed=2, elementwise=False,
                overflow=True)
    # 20k splats on twelve tiles: every tile's queue passes the dense
    # kernels' capacity several times, so a scan pass hands over in
    # windows, and every segment's list takes several scan passes of the
    # list kernels, which carry incomplete chunks from pass to pass
    dense = blob_splats(20_000, 48, 64, 7, dev)
    errs = compare_all("dense tiles", dense, 48, 64, seed=2,
                       elementwise=False)
    if errs["rects"][1] <= 2 * 2048:
        fail("dense tiles: the scene was meant to overflow the tile queue")
    for backend in sized_backends(dense, 48, 64).values():
        lists = backend_paths(backend, dense, 48, 64)[4][0]
        if int(lists.seg_count.max()) <= 2 * LIST_PASS:
            fail(f"dense tiles: the lists of {backend} were meant to be "
                 "longer than two scan passes")
    front = opaque_front(mid, 187, 250, 8)
    compare_all("opaque front", front, 187, 250, seed=2, elementwise=False)
    with torch.no_grad():
        _, tfin_front, _ = backend_paths("pallas", front, 187, 250)[2]()
    stopped = float((tfin_front[:, :100] < 2e-4).float().mean())
    log(f"opaque front: {stopped * 100:.1f}% of the left 100 columns ended "
        "at the latched stop")
    if stopped < 0.5:
        fail("opaque front: the scene was meant to saturate the left tiles")

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
        if launches != {"KR": TRAIN_ITERS, "K1": TRAIN_ITERS,
                        "K2": TRAIN_ITERS, "K3": 0, "K4": 0, "K5": 0,
                        "K6": 0}:
            fail(f"dense run: kernel launches {launches} != {TRAIN_ITERS} "
                 "each of KR, K1 and K2")
        # launches of each kernel on its own path's run
        path_launches = {k: launches[k] for k in ("KR", "K1", "K2")}
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
        if (fwd != TRAIN_ITERS or bwd != TRAIN_ITERS
                or launches["KR"] != TRAIN_ITERS):
            fail(f"auto run: forward launches {fwd}, backward {bwd}, KR "
                 f"{launches['KR']}, expected {TRAIN_ITERS} each ({launches})")
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
            if any(launches[k] != TRAIN_ITERS for k in ("KR", kf, kb)):
                fail(f"{kind} run: KR/{kf}/{kb} launched {launches['KR']}/"
                     f"{launches[kf]}/{launches[kb]} times, expected "
                     f"{TRAIN_ITERS}")
            path_launches.update({kf: launches[kf], kb: launches[kb]})
        log("steady ms/iter by backend: " + ", ".join(
            f"{k} {v:.2f}" for k, v in steady.items()))

        # ---- phase 5: the training shape, trained scene ------------------
        rows = training_shape(params, cam, dev, path_launches)

        # ---- phase 6: stages 3 and 5 on the dense run's model ------------
        stages_3_and_5(scene, Path(tmp) / "dense", dev, smi)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
