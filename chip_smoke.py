#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's stages 1, 2, 3 and 5, the tools
around them (init_test_pose, run_eval, run_infer, the viewer, the
validation sweep, the demo), the MASt3R sparse-alignment family, MASt3R
pre-training, the multi-device layer and the structured render entry
points, on one NVIDIA card and check them.

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
   0.1 off its true pose by 200 Adam steps through KR, K1 and K2 with the
   Gaussians frozen (each view's best loss must fall below its start loss
   and its pose come nearer the truth), then rendered; the FPS benchmark;
   the interpolated path with --backend auto; results.json (finite PSNR,
   SSIM and ATE, LPIPS null). Launch counts of KR, K1 and K2 must equal
   the renders and refinement steps (the refiner's steps are replays of
   one captured CUDA graph). 20 refinement steps under torch.profiler
   (the card's busy share of a replayed step). Then the refiner on
   the card against the CPU (10 steps on a small view, pose within 1e-5)
   and LPIPS with random weights on a 512x384 pair, card against CPU
   (relative 1e-4: full float32, no TF32). Prints ms per refinement
   iteration, seconds per view, FPS, ms per interpolated frame and the
   metrics stage's seconds beside the card's name and power limit.

7. Stage 1 (init_geo), which launches none of the seven kernels, on
   copies of phase 4's dataset (the 15 PNG frames and sparse/0; phase 4's
   sparse_3 left out): the full-width MASt3R (ViT-L encoder, two 12-block
   decoders, DPT + local-feature heads) with random:0 weights on one pair
   in float32 (TF32 off) against the CPU, relative L2 of the encoder
   tokens, every decoder hook, pts3d, conf and desc; bf16 against float32
   over all six pairs under tests/test_mast3r.py's law; encoder ms per
   image and decoder + heads ms per pair (batch 6) in bf16 and float32.
   The drawn weights are saved as random0.pth, which the CLIs of phases 7
   and 8 load (a user's checkpoint path; the draw is not repeated). Then
   instantsplat_tpu_torch.cli.init_geo.main as scripts/run_eval.py calls
   it (--ckpt_path random0.pth --focal_avg --co_vis_dsp
   --conf_aware_ranking, bf16): every artifact, finite points and poses,
   the stage's wall time and its parts. Then run_init_geo with an oracle
   pointmap backend (the ray-cast geometry of the three train views plus
   seeded noise of 0.01) and 300 aligner iterations: the focal within 5%
   and every pose within 1 degree and 1% of the scene scale of the truth
   (relative to the first camera); the card's aligner against the CPU's
   on the same inputs (100 iterations); device events per aligner
   iteration (torch.profiler). Last, 20 iterations of
   cli.train (--backend pallas) on the oracle output: the loss falls and
   KR, K1 and K2 launch 20 times each.

8. The rest of the toolchain, on copies of phase 7's oracle scene (the 15
   frames, sparse/0 and the oracle init_geo's sparse_3), full width:
   run_init_test_pose with the oracle pointmaps of all 15 frames (3 train
   + 12 test, 210 directed pairs, 500 aligner iterations): each test
   pose's rotation within 1 degree of the truth relative to the first
   train camera (centre errors and the registration scale printed, not
   gated: the reference's [R, s*T] transport moves centres by
   (1 - s) R c), no compositor launch; cli.init_test_pose --ckpt_path
   random0.pth (float32 MASt3R over the 210 pairs): finite test poses, its
   parts; cli.run_eval --skip_init (stages 2-5 as subprocesses, 200
   iterations, 50 refinement steps a test view): rc 0, four logs,
   results.json with a finite PSNR, and no stage ran nvcc again (the
   libraries under build/ unchanged); cli.run_infer (init_geo
   --infer_video on three frames with random0.pth, 20 iterations, the
   interpolated video's frames); cli.train --enable_viewer
   --test_iterations 10 20 (20 iterations, --backend pallas) with a
   loopback client that sends a view request before training starts (its
   image within 1/255 of render() of the same camera and the initial
   scene) and four during it (their round trips timed); KR/K1 launched
   once per iteration, viewer request and sweep render; the sweep's tags in
   scalars.jsonl; cli.demo: scene.glb and scene.ply (preview.png, or its
   printed skip). Prints each part's seconds beside the card's name and
   power limit.

9. The sparse-alignment family at full width, reusing phase 4's trained
   model and phase 7's bf16 random:0 MASt3R with its six pairs: (1) the
   three train views' exact pointmaps with integer 24-d descriptors of the
   surface point (`world_desc`: every matcher distance exact in float32),
   extract_matches (subsample 8) and sparse_global_alignment (300 + 300,
   kinematic chain, opt_depth) held to tests/test_aligner.py's gates
   (relative rotation < 0.05 rad, translation < 0.15, scales within 0.2
   of 1, focals within 15%); the card's matches of edge (0, 1) equal to
   the CPU's (seeds every 16th pixel, the CPU's time) and 30 + 30
   iterations card against CPU (c2w within 1e-3);
   the matcher's 10 fixed-trip rounds on edge 0 launched eagerly and as
   one CUDA-graph replay (results equal), the round after which the last
   seed converged and the ms of those rounds alone;
   (2) the same on the MASt3R pairs' descriptors at 100 + 100 (finite
   outputs, shapes);
   (3) refine_matches_coarse_to_fine (maxdim 256) with the oracle field
   (every match within 1.5 px of the truth) and with MASt3R on each crop
   pair; (4) tsdf_refine_depth (2 iterations, 128 samples) on the oracle
   depth maps with noise 0.05 on view 0 (interior error below 0.7x), card
   against CPU on the same normals (equal on >= 99.9% of pixels),
   triangulate_matches and the COLMAP database's row counts; (5) on phase
   4's model, gradient statistics from K2's d(packed) over 10 dense
   iterations, then prune, clone and split (each >= 1% of the points),
   20 train steps (--backend pallas: KR, K1, K2 20 launches each, the loss
   falls) and KR/K1/K2 against the plain version at the new N; (6) the
   EXR codec's build, C++ against Python decoders bit for bit, and a
   three-frame Blender scene read by read_nerf_synthetic and rendered
   through KR/K1 (one launch each). Prints each part's seconds and peak
   card memory. Both sparse-alignment phases run captured (replays of one
   CUDA graph of their step).
10. MASt3R pre-training at full width (ViT-L/BaseDecoder, phase 7's
   float32 random:0 weights, not drawn again): (a) an 8-view posed scene
   at 512x384 written by `write_synthetic_scene` (PNG images, .npy
   depths: no Pillow); (b) one float32 training micro-batch (a 224x224
   pair, mast3r_finetune with 256 correspondences) on the card against
   the CPU: loss within 1e-4 relative, the global gradient norm and seven
   named leaves within 1e-3 relative L2; (c) `cli.pretrain.main` in
   process: mast3r_finetune with 1024 correspondences, colour jitter,
   --bf16, 20 optimizer steps of 2 x accum 2 pairs, 4 loader threads, the
   CLI's default learning rate and warmup; steps 8-10 run under
   torch.profiler (busy share of the loop, top kernels); prints the
   synchronised ms per step (median and spread of the last 10) and the
   loop's, pairs/s, the achieved TFLOP/s (FLOP from the config), peak card
   memory, the checkpoint's size and save seconds; every step's loss must
   be finite and the loss must fall; (d) `train_loop` resumes that
   checkpoint at step 20 and runs to 25 (history 21..25), with its load
   seconds; (e) 8 float32 steps at the same shape (WARMUP eager, a
   capture, 4 replays timed). The pointmap scale
   (max |pts3d|) is printed at the start, at step 20 and at step 25.
   Every optimizer step after the first WARMUP of a step function is one
   replay of its captured CUDA graph. KR and K1-K6 must launch 0 times
   over the phase.
11. The multi-device layer (parallel/) on the one card: NCCL refuses two
   ranks on one device, so (a) every rank's local part of the sharded
   renders runs here, for 2, 3, 4 and 5 virtual ranks on phase 4's model
   at 512x384 (384 rows divide by 2, 3 and 4; 5 gives ragged 77-row
   blocks): row blocks through KR/K1/K2 and through K3/K4 (capacities
   sized over the blocks), depth slices of the sorted splats (padded to a
   multiple of the ranks) and the 2x2 hybrid through KR/K1/K2, joined
   with the module's own join and merge code and held to the one-device
   render (rgb and alpha within 5e-4, depth within 5e-4 of its range,
   d(packed) within 1e-3 relative L2); (b) a child process
   (`python -m chip_smoke --phase11-rank <tmp>`) brings up a one-rank
   NCCL group and drives the library's entry points against their
   one-device runs: train_joint(mesh=) 30 iterations on each shard axis
   (loss curves within LOSS_RTOL) and 10 sharded steps under
   torch.profiler (the card's busy share), refine_poses_sharded on phase
   6's twelve test views (30 steps), align(mesh=) on phase 7's oracle
   pairs (300 iterations), and 5 float32 one-device, DDP and FSDP steps
   of the full-width MASt3R from phase 10's weights (2 pairs at 224x224,
   losses within 1e-4): FSDP's through phase 13 (h)'s one-step check (a
   replay against two eager steps from the same state; lr equal to
   lr_sched), three more replays, each whole step under
   set_sync_debug_mode("error"), and one under torch.profiler (0 kernel
   launch calls, one cudaGraphLaunch); ms per step, warm-up against
   replays, and peak memory beside DDP's. train_joint, align and every
   pre-training step over the mesh run captured, their collectives in the
   graphs (NCCL). KR, K1, K2, K3 and K4 must launch in the phase.
12. The structured entry points (the JAX package's drop-ins for
   rasterize.composite) on phase 4's dense model at 512x384, 100k splats:
   prepare_sorted_splats bit-equal to prepare_packed_splats;
   composite_tiles' forward bit-equal to composite_tiles_packed's and each
   input's gradient equal to its columns of the d(packed) its own K2
   launch wrote (log-opacity zero on invalid rows), that d(packed) within
   1e-5 relative L2 of the packed call's; composite_tiles against
   rasterize.composite's plain path (image 5e-4, gradients 1e-3 relative
   L2); structured composite_tiles_binned / composite_tiles_2d at
   capacities from bin_requirements / tile_requirements, forward
   bit-equal to their _packed twins; project_gaussians on the card
   against the CPU (1e-5). Prints the phase's seconds beside the card's
   name and power limit. KR and K1-K6 must launch in the phase.

13. The device-resident loops (JAX's make_train_scan / scan=True, the
   refiner's and the aligner's fori_loop blocks) as replays of captured
   CUDA graphs against their eager loops, in one call: cli.train with
   scan=False on phase 4's scene for pallas, auto and phase 4's tiled and
   binned strings (each loss curve within LOSS_RTOL of phase 4's captured
   run of the same backend; no replay; KR and a forward kernel 200
   times), then at the training shape on phase 4's model, for pallas,
   tiled and binned: one captured step against one eager step from the
   same state (parameters and first moments within twice the spread of
   two eager steps by relative L2, plus 1e-6), 10 captured iterations and
   10 eager ones under torch.profiler (cudaGraphLaunch calls must equal
   the iterations replayed; kernel launch API calls per iteration, the
   device's busy share, device launches by kernel), 30 of each timed
   between two synchronisations, the peak memory; the refiner's ms a
   step on phase 6's views (4 x 100 captured, 2 x 100 eager); the
   aligner's ms an iteration on phase 7's oracle pairs (300, captured and
   eager). Then the loops of slice 13, each captured against eager in
   this call: (g) both sparse-alignment phases on phase 9's oracle
   inputs (100 + 100; c2w within SPARSE_POSE_ATOL), (h) the full-width
   pre-training step at phase 10's shape from phase 7's random:0
   weights: in float32, one replay after the capture's step against two
   eager steps from the same state (parameters and first moments within
   twice the eager spread by relative L2, + 1e-6) and the replays' lr
   equal to lr_sched(step) in float32 exactly; in bf16, WARMUP eager
   steps, then 6 captured and 3 eager, timed and profiled (loss curves
   within LOSS_RTOL as a sanity check only: the warm-up steps, eager in
   both runs, show the spread of bf16 atomics amplified by Adam, and a
   warm-up learning rate moves the loss too little to tell a broken
   step), (i) in a child process
   (`python -m chip_smoke --phase13-rank <tmp>`) with a one-rank NCCL
   group,
   train_joint over the mesh (60 iterations in blocks of 10; loss curves
   within LOSS_RTOL; the captured run with TrainerConfig.profile_dir,
   whose one trace file must hold block 1's annotate span and K1's and
   K2's kernels 10 times each, and nothing of block 0) and align over it
   (100 iterations; poses within ALIGN_POSE_ATOL). Each prints ms per iteration or step, kernel launch
   API calls and cudaGraphLaunch calls per iteration (torch.profiler
   over replays only; one cudaGraphLaunch an iteration is required), the
   busy share, peak memory and the largest difference of the two runs.
   Prints each number beside the card's name and power limit. Phase 4
   checks each captured run's replays (all iterations but the first
   WARMUP of each graph).

The last lines are one JSON object {"kernels": [...]} with seven entries
(each with `launches`, from its own path's run in phase 4,
`launches_phase8`, from phase 8's in-process runs: its subprocess stages
count in their own processes, `launches_phase9`, from phase 9's
densification check, `launches_phase10`, 0 for every kernel, and
`launches_phase11`, phase 11's in both of its processes, and
`launches_phase12`, phase 12's, and `launches_phase13`, phase 13's), the
nvidia-smi line, and {"ok": true, "device": {...}}. A launch is one on
the device: a kernel launched by a replay of a captured CUDA graph counts
once per replay (rasterize_pallas.Kernel.replayed); its wrapper, called
while the graph was captured, launched nothing then.
"""

from __future__ import annotations

import contextlib
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
# the reference refines 500 steps a view; cut for the smoke's time limit
REFINE_ITERS = 200
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
# Phase 7 (stage 1). The full-width MASt3R in float32 (TF32 off) on the
# card against the CPU, relative L2: summation orders differ (cuBLAS /
# cuDNN against oneDNN) by ~1e-7 relative per matmul and grow through 24
# encoder and 12 decoder blocks of random weights to ~1e-6; pts3d
# (expm1 of the head's output norm) and conf (exp) scale an absolute error
# by the output's magnitude, so they get ten times the room
MAST3R_FP32_RTOL = 1e-4
MAST3R_HEAD_RTOL = 1e-3
ALIGN_ITERS = 300  # the reference's global alignment
# the card's aligner against the CPU's on the same oracle inputs (100
# iterations: 300 take the CPU ~30 s): the backward of the per-edge
# gathers adds with atomics on the card, so the two differ by rounding,
# which Adam on a well-posed loss keeps small
ALIGN_COMPARE_ITERS = 100
ALIGN_LOSS_RTOL = 1e-3
ALIGN_POSE_ATOL = 1e-3
ORACLE_NOISE = 0.01  # on the oracle pointmaps (the cameras stand 4 away)
SCENE_SCALE = 4.0  # the cameras' distance from the surface's centre
STAGE1_TRAIN_ITERS = 20
# Phase 8 (the rest of the toolchain). init_test_pose over all 15 frames:
# 3 train + 12 test images, 210 directed pairs, the reference's 500
# aligner iterations
ITP_ALIGN_ITERS = 500
# run_eval's stages 2-5 and run_infer, depth cut to stay in the budget
EVAL_TRAIN_ITERS = 200
EVAL_REFINE_ITERS = 50
INFER_TRAIN_ITERS = 20
# cli.train with the viewer and the validation sweep
VIEWER_ITERS = 20
VIEWER_LOG_EVERY = 10
VIEWER_TEST_ITERS = (10, 20)
# view requests the loopback client sends: the first before training
# starts (its image is checked), the others one after another during it
# (their round trips are timed; the first of them meets the warm-up step)
VIEWER_REQUESTS = 5
# Phase 9 (the sparse-alignment family). The sparse aligner's defaults:
# subsample 8, 300 coarse + 300 fine iterations; card against CPU over 30
# + 30 (the backward of the gathers adds with atomics on the card), poses
# within 1e-3 as stage 1's aligner
# phase 7 saves its random:0 draw here (in the run's temporary directory);
# the CLIs of phases 7 and 8, phase 10 and phase 11 load it
RANDOM0_PTH = "random0.pth"
SPARSE_SUBSAMPLE = 8
MATCH_MAX_ITER = 10  # fast_reciprocal_nns's rounds
CPU_MATCH_SEEDS = 768  # the main path's seeds that the CPU matches too
SPARSE_ITERS = 300
SPARSE_COMPARE_ITERS = 30
SPARSE_POSE_ATOL = 1e-3
C2F_MAXDIM = 256
TSDF_NOISE = 0.05  # on view 0's depth map (the cameras stand 4 away)
DENSIFY_STATS_ITERS = 10
DENSIFY_TRAIN_ITERS = 20
# Phase 10 (MASt3R pre-training): an 8-view posed scene at 512x384,
# mast3r_finetune with 1024 correspondences a pair, colour jitter; 20 bf16
# optimizer steps of 2 x accum 2 pairs (36 pairs a pass), then a resume
# to 25
PRETRAIN_VIEWS, PRETRAIN_H, PRETRAIN_W = 8, 384, 512
PRETRAIN_CORRES = 1024
PRETRAIN_BATCH, PRETRAIN_ACCUM = 2, 2
PRETRAIN_STEPS, PRETRAIN_RESUME_TO, PRETRAIN_EPOCHS = 20, 25, 4
# cli.pretrain's defaults: with 100 warmup steps the learning rate climbs
# to 2.5e-5 by step 25
PRETRAIN_HYPER = dict(base_lr=1e-4, min_lr=1e-6, warmup_steps=100,
                      weight_decay=0.05)
# the CLI's steps that run under torch.profiler: before the last 10, which
# are timed
PRETRAIN_PROFILED = (8, 9, 10)
PRETRAIN_TIMED = 10
# float32 (TF32 off) training micro-batch, card against CPU: the loss to
# 1e-4 relative; the gradients (global norm and the named leaves, one in
# each part of the model) to 1e-3 relative L2, as they sum over the
# backward's longer chain of cuBLAS / cuDNN against oneDNN orders
PRETRAIN_LOSS_RTOL = 1e-4
PRETRAIN_GRAD_RTOL = 1e-3
PRETRAIN_LEAVES = (
    "patch_embed.proj.weight", "enc_blocks.0.attn.qkv.weight",
    "enc_blocks.23.mlp.fc2.weight", "dec_blocks.0.cross_attn.projk.weight",
    "dec_blocks2.11.mlp.fc1.weight", "downstream_head1.dpt.head.2.weight",
    "downstream_head2.head_local_features.fc2.weight")
BF16_PEAK = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
# phase 11: virtual ranks on the one card (384 rows divide by 2, 3 and 4;
# 5 ranks make ragged 77-row blocks, the last one padded)
P11_WORLDS = (2, 3, 4, 5)
P11_IMAGE_ATOL = 5e-4
P11_GRAD_RTOL = 1e-3
P11_TRAIN_ITERS = 30  # cut from 50 for the time limit
P11_REFINE_ITERS = 30
P11_PRETRAIN_STEPS = 5  # WARMUP eager, a capture, a replay (each mode)
P11_PRETRAIN_HW = 224  # phase 10's float32 micro-batch side
P11_PRETRAIN_RTOL = 1e-4
P11_LIMIT_S = 600  # the one-rank group's child process
# phase 13 (g)-(i): the loops ported in slice 13, captured against eager
P13_PROFILED = 10  # iterations or steps under torch.profiler, each mode
P13_PRETRAIN_CAPTURED, P13_PRETRAIN_EAGER = 6, 3  # after WARMUP steps
P13_PRETRAIN_PROFILED = 1  # an eager step makes ~22.5k launches
P13_SPARSE_ITERS = 100  # each phase, captured and eager
P13_ALIGN_ITERS = 100  # align over the mesh, captured and eager
P13_TRAIN_ITERS, P13_LOG_EVERY = 60, 10


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


def surface_hits(w2c, fx, cx, cy):
    """[H, W, 3] world points where the rays of `w2c`'s pixels (principal
    point cx, cy) meet the relief surface."""
    import numpy as np

    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    c2w = np.linalg.inv(w2c)
    d = np.stack([(gx - cx) / fx, (gy - cy) / fx,
                  np.ones_like(gx, np.float64)], -1) @ c2w[:3, :3].T
    o = c2w[:3, 3]
    t = -o[2] / d[..., 2]  # plane z = 0, then fixed-point refinement
    for _ in range(8):
        p = o + t[..., None] * d
        t = (surface(p[..., 0], p[..., 1]) - o[2]) / d[..., 2]
    return o + t[..., None] * d


def ray_cast(w2c, fx):
    """[H, W, 3] image of the textured relief surface seen by `w2c`."""
    p = surface_hits(w2c, fx, (W - 1) / 2, (H - 1) / 2)
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
    for k in range(len(FRAME_ANGLES)):
        w2c = frame_w2c(k)
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
    version on the same inputs. -> (the max abs differences, forward
    acc/tfin and backward d(packed); the plain backward's ms on these
    inputs by CUDA events, one call)."""
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
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    (grad_p,) = torch.autograd.grad(
        (acc_p * g_acc).sum() + (tfin_p * g_tfin).sum(), [p])
    marks[1].record()
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
    return e_acc, e_grad, marks[0].elapsed_time(marks[1])


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
    name: compare's result} of the sized strings ("rects": compare_rects'
    without its first value)."""
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


@contextlib.contextmanager
def profiled(tag, backend, iters: int, top: int):
    """torch.profiler over the block, which takes `iters` steps and ends
    synchronised: device time per step by kernel name, and the share of
    the block's wall time the card was busy. Yields a dict that gets
    `busy_ms` and `events` on exit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"busy_ms": 0.0, "events": 0}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        yield out
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    n_events = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    if not by_name:
        log(f"profile {tag}: torch.profiler recorded no device events")
        return
    out.update(busy_ms=busy_ms, events=n_events)
    log(f"profile {tag} ({backend}): {iters} iterations, "
        f"{wall_ms / iters:.2f} ms/iter wall "
        f"(profiler on), device busy {busy_ms / iters:.2f} ms/iter = "
        f"{100 * busy_ms / wall_ms:.1f}% (idle {100 - 100 * busy_ms / wall_ms:.1f}%)"
        f", {len(by_name)} kernel names, {n_events / iters:.1f} device "
        "events/iter")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"profile {tag}: {ms / iters:8.3f} ms/iter "
            f"{100 * ms / busy_ms:5.1f}% {name[:110]}")


def profile_iterations(tag, params, cam, dev, backend="auto", top=12,
                       iters: int = 10):
    """`profiled` over `iters` steady steps of the training step on
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
    with profiled(tag, backend, iters, top):
        for i in range(iters):
            step(i + 4)


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
    lines, the overflow guard's demotion warnings, CUDA graph replays)."""
    from instantsplat_tpu_torch.cli import train as train_cli
    from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop

    replays = StepLoop.replays
    (params, history), text, seconds, launches, demotions = run_cli(
        train_cli.main, [
            "-s", scene, "-m", out, "--n_views", 3, "--iterations",
            TRAIN_ITERS, "--pp_optimizer", "--optim_pose", "--sh_degree", 3,
            "--log_every", log_every, "--backend", backend, "--quiet"])
    auto_lines = [ln for ln in text.splitlines() if "backend auto" in ln]
    return (params, history, launches, seconds, auto_lines, demotions,
            StepLoop.replays - replays)


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
        # the plain forward without autograd's recording (compare_all's
        # call on these inputs warmed it); the plain backward: that
        # call's
        with torch.no_grad():
            plain_f_ms = cuda_ms(lambda: plain(packed), 1, 0)
        e_f, e_b, plain_b_ms = errs[kind]
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
    refine = make_pose_refiner(params, cam, num_iter=20)
    refine(pose0, cam.image)  # warm-up steps and the capture
    with profiled("refine (captured: graph replays)", "pallas", 20, top=8):
        refine(pose0, cam.image)
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


def oracle_pointmap_fn(frames, fx, seed=0):
    """pointmap_fn(images, pairs) of the exact geometry of `frames`: each
    pixel's surface point (principal point W/2, H/2, as the aligner's
    unprojection) in view i's camera frame, plus seeded noise of
    ORACLE_NOISE, which keeps the aligner's loss off its rounding floor;
    confidences 1 + exp(U[0, 1)), as tests/test_pipeline_e2e.py's."""
    import numpy as np

    from instantsplat_tpu_torch.init.aligner import PairPrediction

    w2c = [frame_w2c(k) for k in frames]
    world = [surface_hits(m, fx, W / 2, H / 2) for m in w2c]

    def fn(imgs, pairs):
        rng = np.random.default_rng(seed)

        def cam(v, i):  # view v's points in camera i's frame
            return world[v] @ w2c[i][:3, :3].T + w2c[i][:3, 3]

        shape = (len(pairs), H, W, 3)
        pred_i = np.stack([cam(i, i) for i, _ in pairs])
        pred_j = np.stack([cam(j, i) for i, j in pairs])
        conf = 1.0 + np.exp(rng.random(shape[:3]).astype(np.float32))
        noise = ORACLE_NOISE * rng.standard_normal((2,) + shape)
        return PairPrediction(
            edges=list(pairs), pred_i=(pred_i + noise[0]).astype(np.float32),
            pred_j=(pred_j + noise[1]).astype(np.float32), conf_i=conf,
            conf_j=conf * 1.05)

    return fn


def frame_w2c(k):
    """w2c of frame k of the dataset: on an arc of radius 4 about the
    surface's centre, 0.3 above it, looking at it."""
    import numpy as np

    ang = FRAME_ANGLES[k]
    return look_at_w2c((4.0 * np.sin(ang), 0.3, -4.0 * np.cos(ang)))


def rel_l2(a, b) -> float:
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def mast3r_pair(model, x):
    """Encoder tokens, both decoders' hooks and both heads' outputs of the
    pair x [2, H, W, 3]."""
    import torch

    with torch.no_grad():
        f, grid = model.encode(x)
        d1, d2 = model.decode(f[:1], grid, f[1:], grid)
        r1 = model.downstream_head1(d1, H, W)
        r2 = model.downstream_head2(d2, H, W)
    return f, d1, d2, r1, r2


def stage_1_mast3r(scene: Path, dev, smi: str):
    """Phase 7, part 1: the full-width MASt3R with random:0 weights on the
    card; fp32 against the CPU, bf16 against fp32, and the times.
    -> (the bf16 model, its six pairs with descriptors, the three images),
    which phase 9 reuses, and the float32 model on the CPU, which phase 10
    trains (the numpy draw of its weights is not repeated)."""
    import copy

    import numpy as np
    import torch

    from instantsplat_tpu_torch.data.images import load_images
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.models.mast3r_infer import infer_pairs

    imgs = load_images([scene / "images" / f"{k:03d}.png"
                        for k in TRAIN_FRAMES], size=max(H, W))[0]
    t0 = time.time()
    model = mast3r.build_model("random:0", device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"MASt3R ViT-L/BaseDecoder random:0: {n_params / 1e6:.1f} M "
        f"parameters drawn and on the card in {time.time() - t0:.1f} s")

    # fp32, TF32 off: the card against the CPU on one pair
    x = torch.as_tensor(imgs[:2])
    host_model = copy.deepcopy(model).cpu()  # phase 10 trains from it
    t0 = time.time()
    cpu = mast3r_pair(host_model, x)
    cpu_s = time.time() - t0
    card = mast3r_pair(model, x.to(dev))
    worst = {}
    for what, i in (("encoder tokens", 0), ("decoder 1 hooks", 1),
                    ("decoder 2 hooks", 2)):
        if i == 0:
            worst[what] = rel_l2(card[0], cpu[0])
        else:
            worst[what] = max(rel_l2(a, b) for a, b in zip(card[i], cpu[i]))
    for k in ("pts3d", "conf", "desc"):
        worst[k] = max(rel_l2(card[3][k], cpu[3][k]),
                       rel_l2(card[4][k], cpu[4][k]))
    log(f"MASt3R fp32 one pair {W}x{H}, card against the CPU ({cpu_s:.1f} s "
        "on the CPU), relative L2: " + ", ".join(
            f"{k} {v:.3e}" for k, v in worst.items())
        + f" (limits {MAST3R_FP32_RTOL:g}; pts3d and conf "
        f"{MAST3R_HEAD_RTOL:g})")
    for k, v in worst.items():
        lim = MAST3R_HEAD_RTOL if k in ("pts3d", "conf") else MAST3R_FP32_RTOL
        if not v <= lim:
            fail(f"MASt3R fp32 on the card: {k} differs from the CPU by "
                 f"{v:.3e} > {lim:g}")
    del cpu, card

    # bf16 against fp32 on the card: the law of tests/test_mast3r.py
    pairs = make_pair_indices(len(imgs), "complete", symmetrize=True)
    model16 = copy.deepcopy(model).cast(torch.bfloat16)
    p32 = infer_pairs(model, imgs, pairs, batch_size=len(pairs))
    p16 = infer_pairs(model16, imgs, pairs, batch_size=len(pairs))
    for side in ("i", "j"):
        a, b = getattr(p16, f"pred_{side}"), getattr(p32, f"pred_{side}")
        d = np.abs(a - b) / np.abs(b).max()
        q = float(np.quantile(d, 0.999))
        log(f"MASt3R bf16 against fp32, all {len(pairs)} pairs, pred_{side}: "
            f"99.9% quantile {q:.3e} (limit 0.05), max {d.max():.3e} "
            f"(limit 0.5) of max|pts3d| {np.abs(b).max():.3e}")
        if not (q < 0.05 and d.max() < 0.5):
            fail(f"MASt3R bf16 pred_{side} is off the law")
    if not np.isfinite(p16.pred_i).all() or p16.pred_i.dtype != np.float32:
        fail("MASt3R bf16 outputs are not finite float32")

    # times: encoder per image (all three in one batch) and decoder +
    # heads per pair (all six pairs in one batch), warm: CUDA events
    # around eager calls (what the stage sees; in bf16 the host's launches
    # can be the slower) and a CUDA-graph replay (the device's time)
    x3 = torch.as_tensor(imgs, device=dev)
    ei = torch.as_tensor([i for i, _ in pairs], device=dev)
    ej = torch.as_tensor([j for _, j in pairs], device=dev)
    for name, m in (("bf16", model16), ("fp32", model)):
        with torch.no_grad():
            f, _ = m.encode(x3)

            def enc():
                m.encode(x3)

            def dec():
                m.forward_from_encoded(f[ei], f[ej], (H, W))

            ms = {k: (cuda_ms(fn, reps=5) / n, graph_ms(fn, reps=3) / n)
                  for k, fn, n in (("encoder", enc, len(imgs)),
                                   ("decoder + heads", dec, len(pairs)))}
        log(f"MASt3R {name} times [{smi}]: encoder {ms['encoder'][0]:.2f} "
            f"ms per image (graph replay {ms['encoder'][1]:.2f}), decoder + "
            f"heads {ms['decoder + heads'][0]:.2f} ms per pair (graph "
            f"replay {ms['decoder + heads'][1]:.2f}), batch {len(pairs)} "
            "pairs")
    del model
    torch.cuda.empty_cache()
    return model16, p16, imgs, host_model


def stage_1(scene: Path, tmp: Path, dev, smi: str):
    """Phase 7: stage 1 (init_geo) on copies of phase 4's dataset (the 15
    PNG frames and sparse/0, without phase 4's sparse_3). -> (the oracle
    scene, what stage_1_mast3r returns)."""
    import shutil

    import numpy as np
    import torch

    from instantsplat_tpu_torch.cli import init_geo as init_cli
    from instantsplat_tpu_torch.cli import train as train_cli
    from instantsplat_tpu_torch.data import colmap
    from instantsplat_tpu_torch.eval.pose_metrics import (
        align_ate_c2b_use_a2b, rotation_error)
    from instantsplat_tpu_torch.init.aligner import GlobalAligner
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.pipelines.init_geo_pipeline import (
        run_init_geo)

    t_phase = time.time()
    mast3r = stage_1_mast3r(scene, dev, smi)
    # the CLIs of phases 7 and 8 load the drawn weights from a checkpoint
    # file (a user's path) instead of drawing 688 M normals again
    t0 = time.time()
    torch.save(mast3r[3].state_dict(), tmp / RANDOM0_PTH)
    log(f"random:0 weights saved as {RANDOM0_PTH} "
        f"({(tmp / RANDOM0_PTH).stat().st_size / 1e9:.2f} GB) in "
        f"{time.time() - t0:.1f} s")

    copies = {}
    for name in ("cli", "oracle"):
        copies[name] = tmp / f"stage1_{name}"
        shutil.copytree(scene / "images", copies[name] / "images")
        shutil.copytree(scene / "sparse" / "0", copies[name] / "sparse" / "0")

    # ---- cli.init_geo as scripts/run_eval.py calls it ----
    al, _, secs, launches, _ = run_cli(init_cli.main, [
        "-s", copies["cli"], "-m", tmp / "stage1_cli_out", "--n_views", 3,
        "--ckpt_path", tmp / RANDOM0_PTH, "--focal_avg", "--co_vis_dsp",
        "--conf_aware_ranking"])
    sparse = copies["cli"] / "sparse_3"
    for rel in ("0/images.txt", "0/images.bin", "0/cameras.txt",
                "0/points3D.ply", "0/confidence_dsp.npy", "1/images.txt"):
        if not (sparse / rel).is_file():
            fail(f"init_geo: artifact missing: sparse_3/{rel}")
    pts = np.load(sparse / "0" / "points3D_all.npy")
    if not (np.isfinite(pts).all() and np.isfinite(al.get_im_poses()).all()):
        fail("init_geo: non-finite points or poses")
    if any(launches.values()):
        fail(f"init_geo launched compositor kernels: {launches}")
    t = al.timings
    build = secs - sum(t.values())
    log(f"init_geo [{smi}]: {secs:.2f} s for the stage (3 views {W}x{H}, "
        f"bf16, {RANDOM0_PTH}): model build {build:.2f} s, image load "
        f"{t['load']:.2f} s, inference {t['inference']:.2f} s, init_mst "
        f"{t['init_mst']:.2f} s, align {t['align']:.2f} s = "
        f"{t['align'] / ALIGN_ITERS * 1e3:.2f} ms per iteration over "
        f"{ALIGN_ITERS}, writing {t['write']:.2f} s; {len(pts.reshape(-1, 3))}"
        " points")
    del al
    torch.cuda.empty_cache()

    # ---- the aligner against the truth: oracle pointmaps ----
    fx = 0.9 * W
    oracle = oracle_pointmap_fn(TRAIN_FRAMES, fx)
    np.random.seed(0)  # save_points3d's downsample draws from it
    t0 = time.time()
    al = run_init_geo(copies["oracle"], tmp / "stage1_oracle_out", oracle,
                      n_views=3, image_size=max(H, W),
                      niter=ALIGN_ITERS, focal_avg=True,
                      conf_aware_ranking=True, co_vis_dsp=True,
                      max_pts=N_POINTS, save_all_pts=True, device=dev)
    log(f"init_geo oracle on the card: {time.time() - t0:.2f} s, align "
        f"{al.timings['align'] * 1e3 / ALIGN_ITERS:.2f} ms per iteration")
    focal = float(al.get_focals()[0])
    gt = np.stack([np.linalg.inv(frame_w2c(k)) for k in TRAIN_FRAMES])
    # the similarity maps the first train camera onto its truth and scales
    # the centres' spread onto theirs, so each other pose is judged
    # relative to it. A least-squares fit of the centres (the ATE's) or of
    # centres plus points 1/100 of their spread along the optical axes
    # leaves the turn about the centres' chord nearly free: they sit on a
    # 0.3 rad arc, sagitta 0.045 for a chord of 1.2, so a centre error of
    # 1e-3 turns every camera by a degree
    est = al.get_im_poses()

    def spread(c):
        return np.linalg.norm(c[:, None] - c[None], axis=-1).sum()

    est[:, :3, 3] *= spread(gt[:, :3, 3]) / spread(est[:, :3, 3])
    est = gt[0] @ np.linalg.inv(est[0]) @ est
    rot = [np.degrees(rotation_error(g[:3, :3].T @ e[:3, :3]))
           for g, e in zip(gt, est)]
    dist = [float(np.linalg.norm(g[:3, 3] - e[:3, 3]) / SCENE_SCALE)
            for g, e in zip(gt, est)]
    ate = align_ate_c2b_use_a2b(al.get_im_poses(), gt)
    ate_rot = [np.degrees(rotation_error(g[:3, :3].T @ e[:3, :3]))
               for g, e in zip(gt, ate)]
    log(f"init_geo oracle: focal {focal:.2f} against the true {fx:.2f} "
        f"({100 * abs(focal - fx) / fx:.3f}%, limit 5%); relative to the "
        "first camera, rotation errors " + ", ".join(
            f"{r:.4f}" for r in rot) + " degrees (limit 1), centre errors "
        + ", ".join(f"{100 * d:.4f}" for d in dist) + "% of the scene scale "
        "(limit 1%); after the ATE's centre alignment, rotation errors "
        + ", ".join(f"{r:.4f}" for r in ate_rot) + " degrees (not checked)")
    if not abs(focal - fx) / fx < 0.05:
        fail("init_geo oracle: the focal is off the truth by more than 5%")
    if not (max(rot) < 1.0 and max(dist) < 0.01):
        fail("init_geo oracle: a pose is off the truth")

    # the card's aligner against the CPU's on the same inputs
    preds = oracle(None, make_pair_indices(3, "complete", symmetrize=True))
    t0 = time.time()
    cpu = GlobalAligner(preds, device="cpu")
    cpu.init_mst(focal_avg=True)
    cpu_loss = cpu.align(niter=ALIGN_COMPARE_ITERS)
    card = GlobalAligner(preds, device=dev)
    card.init_mst(focal_avg=True)
    card_loss = card.align(niter=ALIGN_COMPARE_ITERS)
    d_loss = abs(card_loss - cpu_loss) / cpu_loss
    d_pose = float(np.abs(card.get_im_poses() - cpu.get_im_poses()).max())
    d_focal = float(np.abs(card.get_focals() - cpu.get_focals()).max())
    log(f"aligner, {ALIGN_COMPARE_ITERS} iterations, card against the CPU "
        f"({time.time() - t0:.1f} s both): final loss {card_loss:.6e} / "
        f"{cpu_loss:.6e}, relative {d_loss:.3e} (limit {ALIGN_LOSS_RTOL:g}); "
        f"poses max |d| {d_pose:.3e} (limit {ALIGN_POSE_ATOL:g}); focal "
        f"|d| {d_focal:.3e}")
    if not (d_loss <= ALIGN_LOSS_RTOL and d_pose <= ALIGN_POSE_ATOL):
        fail("aligner: the card's result differs from the CPU's")
    events = {}
    for n in (0, 10):  # the step launched op by op: its device events
        a = GlobalAligner(preds, device=dev)
        a.init_mst(focal_avg=True)
        with eager_loops(), profiled(f"align {n} iterations (eager)",
                                     "aligner", max(n, 1), top=4) as out:
            a.align(niter=n)
        events[n] = out["events"]
    log(f"aligner: {(events[10] - events[0]) / 10:.1f} device events "
        "(kernel launches and copies) per iteration, each a launch of the "
        "eager step and a node of the captured one")
    if not events[10] > events[0]:
        fail("aligner: torch.profiler saw no device work in its iterations")
    del al, card
    torch.cuda.empty_cache()

    # ---- stage 1 feeds stage 2 ----
    (_, history), _, secs, launches, _ = run_cli(train_cli.main, [
        "-s", copies["oracle"], "-m", tmp / "stage1_train", "--n_views", 3,
        "--iterations", STAGE1_TRAIN_ITERS, "--pp_optimizer", "--optim_pose",
        "--log_every", 1, "--backend", "pallas", "--quiet"])
    losses = [m["loss"] for _, m in history]
    log(f"train on the oracle init_geo output: {len(losses)} iterations in "
        f"{secs:.1f} s, loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches "
        f"{launches}")
    if not losses[-1] < losses[0]:
        fail("train on stage 1's output: the loss did not fall")
    if any(launches[k] != STAGE1_TRAIN_ITERS for k in ("KR", "K1", "K2")):
        fail(f"train on stage 1's output: launches {launches}")
    cams = colmap.read_cameras_text(copies["oracle"] / "sparse_3" / "0"
                                    / "cameras.txt")
    if len(cams) != 3:
        fail("init_geo oracle: sparse_3/0 does not hold three cameras")
    log(f"phase 7: {time.time() - t_phase:.1f} s")
    return copies["oracle"], mast3r


def test_frames():
    """The dataset's test frames in split_train_test's order."""
    return [k for k in range(len(FRAME_ANGLES)) if k not in TRAIN_FRAMES]


def judge_test_poses(tag, sparse3: Path, test_c2w):
    """Rotation errors (gated, 1 degree) and centre errors (printed) of
    transported test poses against the truth, both relative to the first
    train camera of sparse3/0 and the centres scaled onto the truth's, as
    phase 7 judges; -> max rotation error."""
    import numpy as np

    from instantsplat_tpu_torch.data import colmap
    from instantsplat_tpu_torch.eval.pose_metrics import rotation_error

    ims = sorted(colmap.read_images_text(sparse3 / "0" / "images.txt")
                 .values(), key=lambda im: im.name)
    est = ims[0].w2c @ np.asarray(test_c2w)  # in the first train camera
    gt = frame_w2c(TRAIN_FRAMES[0]) @ np.stack(
        [np.linalg.inv(frame_w2c(k)) for k in test_frames()])
    # stage 1's frame has its own scale: the centres' spread (the first
    # camera, at the origin, included) is scaled onto the truth's, as
    # phase 7 does
    def spread(c):
        c = np.concatenate([np.zeros((1, 3)), c])
        return np.linalg.norm(c[:, None] - c[None], axis=-1).sum()

    est[:, :3, 3] *= spread(gt[:, :3, 3]) / spread(est[:, :3, 3])
    rot = [np.degrees(rotation_error(g[:3, :3].T @ e[:3, :3]))
           for g, e in zip(gt, est)]
    dist = [float(np.linalg.norm(g[:3, 3] - e[:3, 3]) / SCENE_SCALE)
            for g, e in zip(gt, est)]
    log(f"{tag}: relative to the first train camera, rotation errors "
        + ", ".join(f"{r:.4f}" for r in rot) + " degrees (limit 1); centre "
        "errors " + ", ".join(f"{100 * d:.2f}" for d in dist)
        + "% of the scene scale after the scale fit (not checked: the "
        "[R, s*T] transport moves them by (1 - s) R c)")
    if not max(rot) < 1.0:
        fail(f"{tag}: a test pose's rotation is off the truth")
    return max(rot)


def viewer_client(port, h, w, view_w2c, result):
    """Thread body: connect to the trainer's viewer (retrying until it
    listens) and send one SIBR request for `view_w2c` before training
    starts, whose image it keeps; then, on the same connection,
    VIEWER_REQUESTS - 1 more during training, one after another, whose
    round trips it times."""
    import json
    import socket

    import numpy as np

    view = np.array(view_w2c, np.float64).T  # stored transposed
    view[:, 1:3] *= -1  # and y/z flipped, as the SIBR viewer sends it
    msg = dict(resolution_x=w, resolution_y=h, train=False, fov_y=0.8,
               fov_x=1.0, z_near=0.01, z_far=100.0, shs_python=False,
               rot_scale_python=False, keep_alive=True, scaling_modifier=1.0,
               view_matrix=view.flatten().tolist(),
               view_projection_matrix=view.flatten().tolist())
    payload = json.dumps(msg).encode("utf-8")
    t0 = time.time()
    while True:
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=120)
            break
        except OSError:
            if time.time() - t0 > 120:
                result["error"] = "the viewer never listened"
                return
            time.sleep(0.01)

    def ask():
        conn.sendall(len(payload).to_bytes(4, "little") + payload)
        buf = b""
        while len(buf) < h * w * 3:
            chunk = conn.recv(h * w * 3 - len(buf))
            if not chunk:
                raise ConnectionError("the viewer closed the connection")
            buf += chunk
        n = int.from_bytes(conn.recv(4), "little")
        result["verify"] = conn.recv(n).decode("ascii")
        return np.frombuffer(buf, np.uint8).reshape(h, w, 3)

    try:
        result["img"] = ask()
        result["round_trip_s"] = []
        for _ in range(VIEWER_REQUESTS - 1):
            t_sent = time.time()
            ask()
            result["round_trip_s"].append(time.time() - t_sent)
    except OSError as e:
        result["error"] = f"{type(e).__name__}: {e}"
    finally:
        conn.close()


def stage_tools(oracle: Path, tmp: Path, dev, smi: str):
    """Phase 8: init_test_pose, run_eval, run_infer, the viewer and the
    validation sweep, and the demo, on copies of phase 7's oracle scene
    (the 15 frames, sparse/0 and the oracle init_geo's sparse_3).
    -> {kernel: launches} summed over phase 8's in-process runs."""
    import os
    import shutil
    import socket
    import threading

    import numpy as np
    import torch

    from instantsplat_tpu_torch.cli import demo as demo_cli
    from instantsplat_tpu_torch.cli import init_test_pose as itp_cli
    from instantsplat_tpu_torch.cli import run_eval as run_eval_cli
    from instantsplat_tpu_torch.cli import run_infer as run_infer_cli
    from instantsplat_tpu_torch.cli import train as train_cli
    from instantsplat_tpu_torch.data import colmap
    from instantsplat_tpu_torch.models.camera import Camera, fov2focal
    from instantsplat_tpu_torch.ops import cuda_build
    from instantsplat_tpu_torch.pipelines.init_test_pose_pipeline import (
        run_init_test_pose)
    from instantsplat_tpu_torch.render.driver import render

    t_phase = time.time()
    seconds = {}
    total = dict.fromkeys(kernel_table(), 0)

    def copy(name):
        dst = tmp / f"p8_{name}"
        shutil.copytree(oracle, dst)
        return dst

    # ---- 1. oracle init_test_pose: 15 frames, 210 pairs, in-process ----
    scene = copy("itp_oracle")
    frames = list(TRAIN_FRAMES) + test_frames()
    oracle_fn = oracle_pointmap_fn(frames, 0.9 * W)
    for k in kernel_table().values():
        k.launches = 0
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    poses = run_init_test_pose(scene, tmp / "p8_itp_oracle_out", oracle_fn,
                               image_size=max(H, W), niter=ITP_ALIGN_ITERS,
                               device=dev, timings=timings)
    torch.cuda.synchronize()
    seconds["init_test_pose oracle"] = time.time() - t0
    launches = {name: k.launches for name, k in kernel_table().items()}
    log(f"init_test_pose oracle [{smi}]: {seconds['init_test_pose oracle']:.2f}"
        f" s for 15 images, 210 pairs: pointmaps {timings['inference']:.2f} s"
        f" (numpy), init_mst {timings['init_mst']:.2f} s, align "
        f"{timings['align']:.2f} s = "
        f"{timings['align'] / ITP_ALIGN_ITERS * 1e3:.2f} ms per iteration "
        f"over {ITP_ALIGN_ITERS}, register + write {timings['write']:.2f} s;"
        f" registration scale s = {timings['scale']:.6f}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if any(launches.values()):
        fail(f"init_test_pose launched compositor kernels: {launches}")
    if poses.shape != (len(test_frames()), 4, 4) or not np.isfinite(
            poses).all():
        fail("init_test_pose oracle: non-finite or missing test poses")
    judge_test_poses("init_test_pose oracle", scene / "sparse_3", poses)
    del oracle_fn
    torch.cuda.empty_cache()

    # ---- 2. cli.init_test_pose with random:0, as a user runs it ----
    scene = copy("itp_cli")
    torch.cuda.reset_peak_memory_stats()
    timings, _, secs, launches, _ = run_cli(itp_cli.main, [
        "-s", scene, "-m", tmp / "p8_itp_cli_out", "--n_views", 3,
        "--ckpt_path", tmp / RANDOM0_PTH, "--focal_avg", "--niter",
        ITP_ALIGN_ITERS])
    seconds["cli.init_test_pose"] = secs
    if any(launches.values()):
        fail(f"cli.init_test_pose launched compositor kernels: {launches}")
    ims = colmap.read_images_text(scene / "sparse_3" / "1" / "images.txt")
    if len(ims) != len(test_frames()) or not all(
            np.isfinite(im.w2c).all() for im in ims.values()):
        fail("cli.init_test_pose: sparse_3/1 lacks finite test poses")
    parts = {k: v for k, v in timings.items() if k != "scale"}
    log(f"cli.init_test_pose [{smi}]: {secs:.2f} s (15 views {W}x{H}, "
        f"float32, random:0, 210 pairs): model build "
        f"{secs - sum(parts.values()):.2f} s, load {parts['load']:.2f} s, "
        f"inference {parts['inference']:.2f} s, init_mst "
        f"{parts['init_mst']:.2f} s, align {parts['align']:.2f} s = "
        f"{parts['align'] / ITP_ALIGN_ITERS * 1e3:.2f} ms per iteration, "
        f"register + write {parts['write']:.2f} s; s = "
        f"{timings['scale']:.4g}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # the stages run in subprocesses: the package must import from there
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])

    def run_tool(main, argv):
        """-> (exit code, seconds, {log name: stage seconds}) of an
        orchestrator whose stages run as subprocesses."""
        import re

        tee = _Tee(sys.stdout)
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(tee):
                main([str(a) for a in argv])
            rc = 0
        except SystemExit as e:
            rc = e.code
        stages = {m.group(2): float(m.group(1)) for m in re.finditer(
            r"-> \w+ \(([0-9.]+)s, log: .*/([0-9a-z_]+)\.log\)",
            "".join(tee.text))}
        return rc, time.time() - t0, stages

    # ---- 3. cli.run_eval --skip_init: stages 2-5 as subprocesses ----
    data = tmp / "p8_eval_data"
    shutil.copytree(oracle, data / "scene")
    libs = sorted(cuda_build.BUILD_ROOT.rglob("*.so"))
    stamps = {p: p.stat().st_mtime_ns for p in libs}
    rc, secs, stage_s = run_tool(run_eval_cli.main, [
        "--data", data, "--out", tmp / "p8_eval_out", "--scenes", "scene",
        "--iterations", EVAL_TRAIN_ITERS, "--optim_test_pose_iter",
        EVAL_REFINE_ITERS, "--skip_init"])
    seconds["cli.run_eval"] = secs
    out = tmp / "p8_eval_out" / "scene" / "3_views"
    logs = sorted((out / "logs").glob("*.log"))
    if rc != 0:
        for log_path in logs:
            log(f"run_eval {log_path.name}: ...{log_path.read_text()[-2000:]}")
        fail(f"run_eval exited {rc}")
    names = [p.stem for p in logs]
    if names != ["02_train", "03_render_train", "04_render_test",
                 "05_metrics"] or sorted(stage_s) != names:
        fail(f"run_eval: logs {names}, stages timed {sorted(stage_s)}")
    res = json.loads((out / "results.json").read_text())
    psnr = res[f"ours_{EVAL_TRAIN_ITERS}"]["PSNR"]
    if not math.isfinite(psnr):
        fail("run_eval: PSNR is not finite")
    if sorted(cuda_build.BUILD_ROOT.rglob("*.so")) != libs or any(
            p.stat().st_mtime_ns != t for p, t in stamps.items()):
        fail("run_eval: a stage built the kernels again (the build key "
             "differs between processes)")
    fps = (out / "total_fps.json").read_text().split()
    log(f"cli.run_eval --skip_init [{smi}]: rc 0 in {secs:.1f} s; stages 2-5"
        " in subprocesses (" + ", ".join(
            f"{k} {v:.1f} s" for k, v in stage_s.items())
        + f"), {EVAL_TRAIN_ITERS} iterations, "
        f"{EVAL_REFINE_ITERS} refinement steps a test view; results "
        f"{res}; FPS {fps}; no stage ran nvcc")

    # ---- 4. cli.run_infer: init_geo --infer_video, train, the video ----
    data = tmp / "p8_infer_data"
    (data / "scene" / "images").mkdir(parents=True)
    for k in TRAIN_FRAMES:
        shutil.copy(oracle / "images" / f"{k:03d}.png",
                    data / "scene" / "images")
    rc, secs, stage_s = run_tool(run_infer_cli.main, [
        "--data", data, "--out", tmp / "p8_infer_out", "--scenes", "scene",
        "--n_views", 3, "--iterations", INFER_TRAIN_ITERS, "--ckpt_path",
        tmp / RANDOM0_PTH])
    seconds["cli.run_infer"] = secs
    out = tmp / "p8_infer_out" / "scene" / "3_views"
    if rc != 0:
        for log_path in sorted((out / "logs").glob("*.log")):
            log(f"run_infer {log_path.name}: ..."
                f"{log_path.read_text()[-2000:]}")
        fail(f"run_infer exited {rc}")
    frames_out = sorted((out / "interp" / f"ours_{INFER_TRAIN_ITERS}"
                         / "renders").glob("*.png"))
    if not frames_out:
        fail("run_infer: no video frames written")
    log(f"cli.run_infer [{smi}]: rc 0 in {secs:.1f} s (3 frames, random:0, "
        f"{INFER_TRAIN_ITERS} iterations; " + ", ".join(
            f"{k} {v:.1f} s" for k, v in stage_s.items())
        + f"); {len(frames_out)} interpolated frames written")

    # ---- 5. cli.train with the viewer and the validation sweep ----
    scene = copy("viewer")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    vh, vw = H, W
    view_w2c = frame_w2c(test_frames()[5])
    result = {}
    client = threading.Thread(target=viewer_client,
                              args=(port, vh, vw, view_w2c, result))
    client.start()
    (_, history), _, secs, launches, _ = run_cli(train_cli.main, [
        "-s", scene, "-m", tmp / "p8_viewer_model", "--n_views", 3,
        "--iterations", VIEWER_ITERS, "--log_every", VIEWER_LOG_EVERY,
        "--test_iterations", *VIEWER_TEST_ITERS, "--backend", "pallas",
        "--enable_viewer", "--port", port, "--quiet"])
    client.join(timeout=120)
    if client.is_alive():
        fail("viewer: the client thread did not finish")
    seconds["cli.train viewer"] = secs
    for k, v in launches.items():
        total[k] += v
    if len(result.get("round_trip_s", ())) != VIEWER_REQUESTS - 1 or \
            result.get("verify") != "training":
        fail(f"viewer: not every request answered ({result.get('error')})")
    params, _ = initial_params(scene, dev)
    cam = Camera.create(view_w2c[:3, :3], view_w2c[:3, 3],
                        fx=fov2focal(1.0, vw), fy=fov2focal(0.8, vh),
                        height=vh, width=vw, device=dev)
    with torch.no_grad():
        want = render(params, cam, backend="pallas").render.cpu().numpy()
    diff = float(np.abs(result["img"] / 255.0 - want).max())
    sweeps = len(VIEWER_TEST_ITERS) * 3
    trips = ", ".join(f"{t * 1e3:.1f}" for t in result["round_trip_s"])
    log(f"viewer [{smi}]: {vw}x{vh} images; requests sent during training "
        f"answered in {trips} ms (each at the trainer's next iteration: a "
        f"step, a render and the transfer); the first image against render() "
        f"of the initial scene: max |d| {diff:.2e} (limit 1/255); cli.train "
        f"{VIEWER_ITERS} iterations in {secs:.1f} s with the sweep at "
        f"{VIEWER_TEST_ITERS}; launches {launches}")
    if not diff <= 1 / 255:
        fail("viewer: the served image differs from render()")
    want_launches = {"KR": VIEWER_ITERS + VIEWER_REQUESTS + sweeps,
                     "K1": VIEWER_ITERS + VIEWER_REQUESTS + sweeps,
                     "K2": VIEWER_ITERS,
                     "K3": 0, "K4": 0, "K5": 0, "K6": 0}
    if launches != want_launches:
        fail(f"viewer run: launches {launches} != {want_launches} (the "
             "iterations, the viewer's renders and the sweep's)")
    rows = [json.loads(ln) for ln in (tmp / "p8_viewer_model"
                                      / "scalars.jsonl").read_text()
            .splitlines()]
    sweep = sorted((r["step"], r["tag"]) for r in rows
                   if "viewpoint" in r["tag"])
    want_sweep = sorted((it, f"train/loss_viewpoint-{m}")
                        for it in VIEWER_TEST_ITERS for m in ("l1", "psnr"))
    if sweep != want_sweep:
        fail(f"validation sweep: scalars {sweep} != {want_sweep}")
    log("validation sweep: " + ", ".join(
        f"{r['tag']}@{r['step']} {r['value']:.5f}" for r in rows
        if "viewpoint" in r["tag"]))
    del params

    # ---- 6. cli.demo on the oracle scene ----
    scene = copy("demo")
    _, text, secs, launches, _ = run_cli(demo_cli.main, [
        "-s", scene, "--n_views", 3, "--outdir", tmp / "p8_demo"])
    seconds["cli.demo"] = secs
    if any(launches.values()):
        fail(f"demo launched compositor kernels: {launches}")
    for f in ("scene.glb", "scene.ply"):
        if not (tmp / "p8_demo" / f).is_file():
            fail(f"demo: {f} missing")
    skipped = [ln for ln in text.splitlines() if "skipped" in ln]
    log(f"cli.demo: {secs:.2f} s; scene.glb "
        f"{(tmp / 'p8_demo' / 'scene.glb').stat().st_size} B, scene.ply "
        f"{(tmp / 'p8_demo' / 'scene.ply').stat().st_size} B"
        + (f"; {skipped[0].strip()}" if skipped else "; preview.png written"))
    log(f"phase 8 [{smi}]: {time.time() - t_phase:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()))
    return total


# --------------------------------------------------------------------------
# phase 9: the sparse-alignment family
# --------------------------------------------------------------------------


def world_desc(world):
    """[..., 3] world points -> [..., 24] descriptors, an injective
    function of the surface point: 100 x (sin and cos of x and of y at
    five incommensurate frequencies, and x, y, (x + y)/sqrt2, (x - y)/sqrt2),
    rounded to integers. The high frequencies turn by ~1 rad a pixel, so
    the nearest descriptor is the nearest pixel; the linear part keeps the
    distance growing with the distance on the surface, so no far point
    aliases a near one (crop pairs then give no spurious mutual matches).
    Integer entries this small make every distance the matcher computes
    exact in float32, whatever the order of summation, so the card and the
    CPU compare the same numbers."""
    import numpy as np

    freqs = np.array([3.1, 7.3, 17.9, 41.3, 97.1])
    x, y = world[..., 0:1], world[..., 1:2]
    f = np.concatenate([np.sin(x * freqs), np.cos(x * freqs),
                        np.sin(y * freqs), np.cos(y * freqs), x, y,
                        (x + y) / np.sqrt(2), (x - y) / np.sqrt(2)], -1)
    return np.round(100.0 * f).astype(np.float32)


def relative_pose_error(c2w_a, c2w_b):
    """tests/test_aligner.py's gauge-free error: the largest rotation
    angle (rad) and normalised translation error over all relative
    poses."""
    import numpy as np

    n = len(c2w_a)
    rot_err, t_err = 0.0, 0.0
    ca, cb = c2w_a[:, :3, 3], c2w_b[:, :3, 3]
    sa = np.linalg.norm(ca - ca.mean(0), axis=1).mean() + 1e-12
    sb = np.linalg.norm(cb - cb.mean(0), axis=1).mean() + 1e-12
    for i in range(n):
        for j in range(i + 1, n):
            Ra = c2w_a[i][:3, :3].T @ c2w_a[j][:3, :3]
            Rb = c2w_b[i][:3, :3].T @ c2w_b[j][:3, :3]
            cos = (np.trace(Ra.T @ Rb) - 1) / 2
            rot_err = max(rot_err, np.arccos(np.clip(cos, -1, 1)))
            ta = c2w_a[i][:3, :3].T @ (ca[j] - ca[i]) / sa
            tb = c2w_b[i][:3, :3].T @ (cb[j] - cb[i]) / sb
            t_err = max(t_err, np.linalg.norm(ta - tb))
    return rot_err, t_err


def sparse_oracle():
    """The three train views' exact pointmaps at full width (six directed
    edges, principal point W/2, H/2) with `world_desc` descriptors.
    -> (PairPrediction, [V, H, W, 3] world points, [V, 4, 4] true w2c)."""
    import numpy as np

    from instantsplat_tpu_torch.init.aligner import PairPrediction
    from instantsplat_tpu_torch.init.pairs import make_pair_indices

    fx = 0.9 * W
    w2c = np.stack([frame_w2c(k) for k in TRAIN_FRAMES])
    world = np.stack([surface_hits(m, fx, W / 2, H / 2) for m in w2c])
    pairs = make_pair_indices(len(w2c), "complete", symmetrize=True)
    conf = 1.0 + np.exp(np.random.default_rng(0).random(
        (len(pairs), H, W)).astype(np.float32))

    def cam(v, i):  # view v's points in camera i's frame
        return world[v] @ w2c[i][:3, :3].T + w2c[i][:3, 3]

    preds = PairPrediction(
        edges=pairs, conf_i=conf, conf_j=conf * 1.1,
        pred_i=np.stack([cam(i, i) for i, _ in pairs]).astype(np.float32),
        pred_j=np.stack([cam(j, i) for i, j in pairs]).astype(np.float32))
    preds.desc_i = np.stack([world_desc(world[i]) for i, _ in pairs])
    preds.desc_j = np.stack([world_desc(world[j]) for _, j in pairs])
    return preds, world, w2c


def timed_matches(preds, dev, subsample=SPARSE_SUBSAMPLE):
    """extract_matches edge by edge -> (matches, ms per edge)."""
    import torch

    from instantsplat_tpu_torch.ops.matching import fast_reciprocal_nns

    out, ms = [], []
    for e in range(len(preds.edges)):
        torch.cuda.synchronize()
        t0 = time.time()
        out.append(fast_reciprocal_nns(preds.desc_i[e], preds.desc_j[e],
                                       subsample=subsample, device=dev))
        torch.cuda.synchronize()
        ms.append((time.time() - t0) * 1e3)
    return out, ms


def matcher_rounds(preds, e, dev, smi):
    """The reciprocal matcher's fixed-trip rounds (`_reciprocal_iterate`,
    MATCH_MAX_ITER of them, no host read between them) on edge e of
    `preds`, from the main path's seeds (every SPARSE_SUBSAMPLE-th pixel):
    ms of the rounds launched eagerly; the round after which the last seed
    converged (the first k with no seed active after k rounds) and the ms
    of the k rounds an early exit would run; the same rounds captured in
    one CUDA graph for the edge's shape (static descriptors and seeds) and
    replayed, whose results must equal the eager rounds'. Then the first
    CPU_MATCH_SEEDS seeds (the grid's first rows; each seed's rounds are
    its own) run on the CPU, whose indices and convergence must equal the
    card's for those seeds."""
    import numpy as np
    import torch

    from instantsplat_tpu_torch.ops.matching import _reciprocal_iterate

    h, w, d = preds.desc_i[e].shape
    d1, d2 = (torch.as_tensor(x[e], dtype=torch.float32,
                              device=dev).reshape(-1, d)
              for x in (preds.desc_i, preds.desc_j))
    ys, xs = np.mgrid[SPARSE_SUBSAMPLE // 2:h:SPARSE_SUBSAMPLE,
                      SPARSE_SUBSAMPLE // 2:w:SPARSE_SUBSAMPLE].reshape(2, -1)
    seeds = torch.as_tensor(np.unique(xs + w * ys), device=dev)

    def rounds(k=MATCH_MAX_ITER, at=seeds):
        return _reciprocal_iterate(d1, d2, at, k, 4096)

    want = rounds()
    eager_ms = synced_ms(lambda: [rounds() for _ in range(5)], 5)
    last = next((k for k in range(1, MATCH_MAX_ITER + 1)
                 if not bool(rounds(k)[2].any())), MATCH_MAX_ITER)
    # the rounds an early exit would have run, without its host reads
    early_ms = synced_ms(lambda: [rounds(last) for _ in range(5)], 5)
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        rounds()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rounds()
    graph.replay()
    replay_ms = synced_ms(lambda: [graph.replay() for _ in range(5)], 5)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    active = int(want[2].sum())
    del graph, got
    torch.cuda.empty_cache()
    t0 = time.time()
    cpu = _reciprocal_iterate(d1.cpu(), d2.cpu(),
                              seeds[:CPU_MATCH_SEEDS].cpu(), MATCH_MAX_ITER,
                              4096)
    cpu_s = time.time() - t0
    differ = int(sum((a[:CPU_MATCH_SEEDS].cpu() != b) for a, b
                     in zip(want, cpu)).ne(0).sum())
    log(f"matcher rounds on edge {preds.edges[e]} ({len(seeds)} seeds, "
        f"{h}x{w} descriptors of {d}) [{smi}]: {MATCH_MAX_ITER} fixed-trip "
        f"rounds {eager_ms:.2f} ms launched eagerly, {replay_ms:.2f} ms as "
        f"one CUDA-graph replay ({eager_ms / replay_ms:.2f}x); the last seed "
        f"converged after round {last} ({active} never did), and its "
        f"{last} rounds alone take {early_ms:.2f} ms; replay results equal "
        f"the eager rounds': {same}; the first {CPU_MATCH_SEEDS} seeds on "
        f"the CPU ({cpu_s:.1f} s, {int((~cpu[2]).sum())} matches): seeds "
        f"whose indices or convergence differ from the card's {differ} "
        f"(limit 0)")
    if not same:
        fail("matcher rounds: the graph replay's results differ from the "
             "eager rounds'")
    if differ:
        fail(f"oracle matching: {differ} seeds differ between the card and "
             "the CPU")


def timed_alignment(tag, preds, matches, dev, n=SPARSE_ITERS):
    """sparse_global_alignment with n + n iterations (its defaults: 300 +
    300), plus runs of 0 + 0 and n + 0 iterations that time the set-up
    and the coarse phase; prints the times. -> (the n + n result, coarse
    and fine ms per Adam iteration)."""
    import torch

    from instantsplat_tpu_torch.init.sparse_align import (
        sparse_global_alignment)

    secs = {}
    for n1, n2 in ((0, 0), (n, 0), (n, n)):
        torch.cuda.synchronize()
        t0 = time.time()
        res = sparse_global_alignment(preds, matches=matches,
                                      subsample=SPARSE_SUBSAMPLE, niter1=n1,
                                      niter2=n2, device=dev)
        torch.cuda.synchronize()
        secs[(n1, n2)] = time.time() - t0
    setup = secs[(0, 0)]
    coarse = (secs[(n, 0)] - setup) / n * 1e3
    fine = (secs[(n, n)] - secs[(n, 0)]) / n * 1e3
    log(f"{tag}: sparse_global_alignment {n} + {n} "
        f"iterations in {secs[(n, n)]:.2f} s: set-up "
        f"{setup:.2f} s, coarse {coarse:.2f} ms per Adam iteration, fine "
        f"{fine:.2f} ms per Adam iteration (host clock); final loss "
        f"{res.loss:.6e}")
    return res, coarse, fine


def mast3r_crop_infer(model):
    """infer_fn(crop1, crop2) -> descriptor maps of the crop pair through
    the port's MASt3R: both crops resized (bilinear) to crop 1's size
    rounded down to a multiple of 16."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from instantsplat_tpu_torch.models.mast3r_infer import infer_pairs

    def fn(c1, c2):
        h = max(16, c1.shape[0] // 16 * 16)
        w = max(16, c1.shape[1] // 16 * 16)
        x = [F.interpolate(torch.as_tensor(np.asarray(c, np.float32))
                           .permute(2, 0, 1)[None], size=(h, w),
                           mode="bilinear", align_corners=False)[0]
             .permute(1, 2, 0).numpy() for c in (c1, c2)]
        p = infer_pairs(model, np.stack(x), [(0, 1)], batch_size=1)
        return p.desc_i[0], p.desc_j[0]

    return fn


def stage_sparse(params, cams, mast3r, tmp: Path, dev, smi: str):
    """Phase 9: the sparse-alignment family on the card at full width.
    `params`/`cams`: phase 4's trained model and its cameras; `mast3r`:
    phase 7's (bf16 random:0 model, its six pairs, the three images).
    -> {kernel: launches} of the densification check."""
    import json as _json
    import sqlite3

    import numpy as np
    import torch

    from instantsplat_tpu_torch.data import colmap_db, exr, png, scene
    from instantsplat_tpu_torch.init import depth_refine
    from instantsplat_tpu_torch.init.sparse_align import (
        refine_matches_coarse_to_fine, sparse_global_alignment)
    from instantsplat_tpu_torch.models import densify
    from instantsplat_tpu_torch.models.gaussians import GaussianModel
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops.losses import photometric_loss
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.pipelines.trainer import train_step
    from instantsplat_tpu_torch.render import driver

    t_phase = time.time()
    seconds = {}
    model16, pairs16, images = mast3r
    fx = 0.9 * W

    def part(name, t0):
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        log(f"phase 9 {name} [{smi}]: {seconds[name]:.2f} s, peak card "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        torch.cuda.reset_peak_memory_stats()

    # ---- 1. oracle sparse alignment ----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    preds, world, w2c = sparse_oracle()
    c2w_gt = np.linalg.inv(w2c)
    matches, ms = timed_matches(preds, dev)
    log(f"oracle matching {W}x{H}, subsample {SPARSE_SUBSAMPLE} [{smi}]: "
        "matches per edge " + ", ".join(str(len(m[0])) for m in matches)
        + f"; ms per edge ({MATCH_MAX_ITER} fixed-trip rounds) "
        + ", ".join(f"{v:.1f}" for v in ms) + " (first edge includes the "
        "warm-up)")
    res, _, _ = timed_alignment("oracle", preds, matches, dev)
    rot, t_err = relative_pose_error(res.c2w, c2w_gt)
    log(f"oracle sparse alignment against the truth: relative rotation "
        f"{rot:.5f} rad (limit 0.05), translation {t_err:.5f} of the scene "
        f"scale (limit 0.15), scales {np.round(res.scales, 5).tolist()} "
        f"(limit 1 +- 0.2), focals {np.round(res.focals, 2).tolist()} "
        f"against {fx:.2f} (limit 15%)")
    if not (rot < 0.05 and t_err < 0.15):
        fail("oracle sparse alignment: poses off the truth")
    if not (np.abs(res.scales - 1).max() < 0.2
            and np.abs(res.focals / fx - 1).max() < 0.15):
        fail("oracle sparse alignment: scales or focals off the truth")
    # the CPU matches the main path's seeds of edge (0, 1) in the grid's
    # first rows (the whole image is the database: 10 fixed-trip rounds
    # from every 8th pixel take the CPU of an H100 machine ~46 s). The
    # descriptors' distances are exact integers, so every edge is decided
    # by the same numbers
    t1 = time.time()
    e01 = preds.edges.index((0, 1))
    matcher_rounds(preds, e01, dev, smi)
    both = {dev_: sparse_global_alignment(
        preds, matches=matches, subsample=SPARSE_SUBSAMPLE,
        niter1=SPARSE_COMPARE_ITERS, niter2=SPARSE_COMPARE_ITERS,
        device=dev_) for dev_ in (dev, "cpu")}
    d_c2w = float(np.abs(both[dev].c2w - both["cpu"].c2w).max())
    log(f"card against the CPU ({time.time() - t1:.1f} s with the matcher "
        f"rounds): sparse alignment {SPARSE_COMPARE_ITERS} + "
        f"{SPARSE_COMPARE_ITERS} iterations c2w max|d| {d_c2w:.3e} (limit "
        f"{SPARSE_POSE_ATOL:g}), loss {both[dev].loss:.6e} / "
        f"{both['cpu'].loss:.6e}")
    if not d_c2w <= SPARSE_POSE_ATOL:
        fail("sparse alignment: the card's poses differ from the CPU's")
    part("oracle sparse alignment", t0)

    # ---- 2. full-width MASt3R descriptors (random:0, bf16) ----
    t0 = time.time()
    m_matches, m_ms = timed_matches(pairs16, dev)
    log(f"MASt3R random:0 bf16 matching: matches per edge "
        + ", ".join(str(len(m[0])) for m in m_matches) + "; ms per edge "
        + ", ".join(f"{v:.1f}" for v in m_ms))
    m_res, _, _ = timed_alignment("MASt3R random:0", pairs16, m_matches,
                                  dev, P13_SPARSE_ITERS)
    n_cells = (-(-H // SPARSE_SUBSAMPLE), -(-W // SPARSE_SUBSAMPLE))
    if not (m_res.c2w.shape == (3, 4, 4) and m_res.scales.shape == (3,)
            and m_res.focals.shape == (3,)
            and m_res.depth_scales.shape == (3, *n_cells)):
        fail("MASt3R sparse alignment: unexpected shapes")
    if not all(np.isfinite(a).all() for a in (
            m_res.c2w, m_res.scales, m_res.focals, m_res.depth_scales,
            m_res.loss)):
        fail("MASt3R sparse alignment: non-finite outputs")
    part("MASt3R sparse alignment", t0)

    # ---- 3. coarse-to-fine, maxdim 256 ----
    t0 = time.time()
    xy1, xy2 = matches[e01]
    f1, f2 = refine_matches_coarse_to_fine(
        world[0], world[1], xy1, xy2,
        lambda c1, c2: (world_desc(c1), world_desc(c2)), maxdim=C2F_MAXDIM,
        device=dev)
    p = world[0][f1[:, 1].astype(int), f1[:, 0].astype(int)]
    pc = p @ w2c[1][:3, :3].T + w2c[1][:3, 3]
    true2 = fx * pc[:, :2] / pc[:, 2:] + [W / 2, H / 2]
    err = np.linalg.norm(f2 - true2, axis=-1)
    log(f"coarse-to-fine, oracle field: {len(xy1)} coarse -> {len(f1)} "
        f"refined matches, distance to the true correspondence median "
        f"{np.median(err):.3f} px, max {err.max():.3f} px (limit 1.5)")
    if not (len(f1) > len(xy1) and err.max() <= 1.5):
        fail("coarse-to-fine with the oracle field: a match is off")
    calls = []
    infer = mast3r_crop_infer(model16)

    def counted(c1, c2):
        calls.append((c1.shape, c2.shape))
        return infer(c1, c2)

    t1 = time.time()
    g1, g2 = refine_matches_coarse_to_fine(
        images[0], images[1], xy1, xy2, counted, maxdim=C2F_MAXDIM,
        device=dev)
    torch.cuda.synchronize()
    log(f"coarse-to-fine, MASt3R random:0 bf16: {len(calls)} crop pairs "
        f"({sorted(set(calls))[:3]} ...) in {time.time() - t1:.2f} s, "
        f"{len(g1)} matches")
    inside = all(((g >= 0) & (g < [W, H])).all() for g in (g1, g2))
    if not (calls and len(g1) and inside):
        fail("coarse-to-fine with MASt3R: no crops, no matches or matches "
             "out of bounds")
    part("coarse-to-fine", t0)

    # ---- 4. TSDF, triangulation, the COLMAP database ----
    t0 = time.time()
    depth = np.stack([(world[v] @ w2c[v][:3, :3].T + w2c[v][:3, 3])[..., 2]
                      for v in range(3)]).astype(np.float32)
    noisy = depth.copy()
    noisy[0] += np.random.default_rng(0).standard_normal(
        (H, W)).astype(np.float32) * TSDF_NOISE
    K = np.tile(np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]]),
                (3, 1, 1))
    torch.cuda.synchronize()
    t1 = time.time()
    refined = depth_refine.tsdf_refine_depth(
        noisy, K, c2w_gt, trunc=0.1, n_iter=2, nsamples=128, device=dev)
    torch.cuda.synchronize()
    tsdf_s = time.time() - t1
    refined = refined.cpu().numpy()
    sl = (0, slice(4, -4), slice(4, -4))
    before = np.abs(noisy[sl] - depth[sl]).mean()
    after = np.abs(refined[sl] - depth[sl]).mean()
    log(f"TSDF refinement {W}x{H}, 3 views, 2 iterations, 128 samples: "
        f"{tsdf_s:.2f} s on the card; interior error {before:.5f} -> "
        f"{after:.5f} ({after / before:.3f}x, limit 0.7x)")
    if not after < 0.7 * before:
        fail("TSDF refinement: the noisy view did not improve enough")
    gen = torch.Generator(device=dev).manual_seed(1)
    normals = [torch.randn((3, H, W, 128), generator=gen, device=dev)
               for _ in range(2)]
    t = {d_: [torch.as_tensor(a, device=d_).float()
              for a in (noisy, K, c2w_gt, np.ones_like(noisy))]
         for d_ in (dev, "cpu")}
    t1 = time.time()
    on_card = depth_refine._refine(*t[dev], 0.1, normals, 32)
    on_cpu = depth_refine._refine(*t["cpu"], 0.1,
                                  [n.cpu() for n in normals], 32)
    eq = float((on_card.cpu() == on_cpu).float().mean())
    d_max = float((on_card.cpu() - on_cpu).abs().max())
    log(f"TSDF card against the CPU on the same normals "
        f"({time.time() - t1:.1f} s both): equal on {eq * 100:.4f}% of "
        "pixels (limit 99.9%); where they differ, another candidate won a "
        f"near-tie: max|d| {d_max:.3e}")
    if not eq >= 0.999:
        fail("TSDF refinement: the card differs from the CPU")
    del normals, t, on_card
    pts, gap = depth_refine.triangulate_matches(
        xy1, xy2, K[0], K[1], c2w_gt[0], c2w_gt[1])
    true = world[0][xy1[:, 1], xy1[:, 0]]
    d_tri = np.linalg.norm(pts - true, axis=-1)
    log(f"triangulate_matches edge (0, 1): {len(pts)} points, distance to "
        f"the surface point median {np.median(d_tri):.4f}, max "
        f"{d_tri.max():.4f}; ray gap median {np.median(gap):.4f}")
    if not (np.isfinite(pts).all() and np.median(d_tri) < 0.05):
        fail("triangulate_matches: points off the surface")
    db = tmp / "p9_colmap.db"
    colmap_db.export_matches_to_colmap_db(
        db, [f"{k:03d}.png" for k in TRAIN_FRAMES], (H, W), [fx] * 3,
        matches, preds.edges, w2c_priors=w2c)
    con = sqlite3.connect(db)
    rows = {tb: con.execute(f"SELECT COUNT(*) FROM {tb}").fetchone()[0]
            for tb in ("images", "keypoints", "matches",
                       "two_view_geometries")}
    con.close()
    log(f"COLMAP database: rows {rows}")
    if rows != {"images": 3, "keypoints": 3, "matches": 3,
                "two_view_geometries": 3}:
        fail(f"COLMAP database: unexpected row counts {rows}")
    part("TSDF, triangulation and the database", t0)

    # ---- 5. densification under the compositors ----
    t0 = time.time()
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    g = params
    bg = torch.zeros(3, device=dev)
    accum = torch.zeros(g.num_points, device=dev)
    denom = torch.zeros(g.num_points, device=dev)
    for it in range(DENSIFY_STATS_ITERS):
        cam = cams[it % len(cams)]
        with torch.no_grad():
            packed, cols = driver.prepare_packed_splats(
                g, g.get_pose(cam.uid), cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
                g.max_sh_degree, H, W)
        # prepare_packed_splats' stable sort of the same keys: packed row r
        # is point perm[r]
        _, perm = torch.sort(torch.where(
            cols.valid, cols.depth, torch.full_like(
                cols.depth, driver._INVALID_DEPTH)), stable=True)
        leaf = packed.contiguous().requires_grad_(True)
        out = RP.composite_tiles_packed(leaf, H, W, bg)
        loss, _ = photometric_loss(out.rgb, cam.image, 0.2)
        (dpacked,) = torch.autograd.grad(loss, [leaf])
        mean2d = torch.empty_like(dpacked[:, :2])
        mean2d[perm] = dpacked[:, :2]  # K2's d(mx, my), back to point order
        accum, denom = densify.accumulate_grad_stats(accum, denom, mean2d,
                                                     cols.valid)
    grads = accum / denom.clamp(min=1)
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True))
    state = opt.init(g)
    sizes = [("trained", g.num_points)]
    opacity = torch.sigmoid(g.opacity[:, 0])
    min_op = float(torch.quantile(opacity, 0.02))
    g, state = densify.prune_points(g, state, min_opacity=min_op)
    grads = grads[opacity >= min_op]
    sizes.append(("prune", g.num_points))
    thr = float(torch.quantile(grads, 0.9))
    scale_max = torch.exp(g.scaling).amax(-1)
    extent = float(torch.quantile(scale_max[grads >= thr], 0.5)) / 0.01
    g, state = densify.densify_and_clone(g, state, grads, thr, extent)
    grads = torch.cat([grads, torch.zeros(g.num_points - len(grads),
                                          device=dev)])
    sizes.append(("clone", g.num_points))
    g, state = densify.densify_and_split(g, state, grads, thr, extent)
    sizes.append(("split", g.num_points))
    log(f"densification of phase 4's model ({DENSIFY_STATS_ITERS} dense "
        f"iterations of statistics, threshold {thr:.4e} px, extent "
        f"{extent:.4f}): N " + " -> ".join(f"{n} ({k})" for k, n in sizes))
    for (_, a), (k, b) in zip(sizes, sizes[1:]):
        if not abs(b - a) >= 0.01 * a:
            fail(f"densification: {k} changed fewer than 1% of the points")
    if state.per_point_lr.shape != (g.num_points, 1) or any(
            state.m[f].shape[0] != g.num_points for f in densify.POINT_FIELDS):
        fail("densification: optimiser state out of step with N")
    stats_launches = {k: v.launches for k, v in kernels.items()}
    losses, stamps = [], [time.time()]
    for it in range(1, DENSIFY_TRAIN_ITERS + 1):
        m = train_step(g, cams[0], opt, state, it, g.max_sh_degree, bg, 0.2,
                       backend="pallas", chunk=256)
        losses.append(float(m["loss"]))  # the loss read ends each step
        stamps.append(time.time())
    launches = {k: v.launches for k, v in kernels.items()}
    trained = {k: launches[k] - stats_launches[k] for k in launches}
    half = DENSIFY_TRAIN_ITERS // 2
    ms_all = (stamps[-1] - stamps[0]) / DENSIFY_TRAIN_ITERS * 1e3
    ms_last = (stamps[-1] - stamps[half]) / half * 1e3
    log(f"{DENSIFY_TRAIN_ITERS} train steps (--backend pallas) at N="
        f"{g.num_points}: {ms_all:.2f} ms/iter ({ms_last:.2f} over the last "
        f"{half}; host clock); loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"launches {trained}; the whole densification check {launches}")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail("train after densification: the loss is not finite or did not "
             "fall")
    if any(trained[k] != DENSIFY_TRAIN_ITERS for k in ("KR", "K1", "K2")):
        fail(f"train after densification: launches {trained}")
    with torch.no_grad():
        packed, _ = driver.prepare_packed_splats(
            g, g.get_pose(cams[0].uid), cams[0].fx, cams[0].fy, cams[0].cx,
            cams[0].cy, 1.0, g.max_sh_degree, H, W)
    packed = packed.contiguous()
    compare_rects("after densification", packed, H, W)
    compare("after densification", packed, H, W, seed=9, elementwise=False)
    part("densification", t0)

    # ---- 6. EXR and the Blender reader ----
    t0 = time.time()
    t1 = time.time()
    exr.build_native()
    log(f"EXR codec built with g++ in {time.time() - t1:.2f} s")
    img = depth[0]
    for half in (False, True):
        for comp in ("none", "zips", "zip"):
            f = tmp / f"p9_{comp}_{half}.exr"
            exr.write_exr(f, img, half=half, compression=comp)
            ms = {}
            for native in (True, False):
                t1 = time.time()
                for _ in range(5):
                    got = exr.read_exr(f, native=native)
                ms[native] = (time.time() - t1) / 5 * 1e3
                if native:
                    first = got
            if not (first.dtype == got.dtype and np.array_equal(first, got)):
                fail(f"EXR {comp} half={half}: the C++ and Python decoders "
                     "differ")
            if not half and not np.array_equal(first, img):
                fail(f"EXR {comp}: the float32 round trip is not exact")
            log(f"EXR {W}x{H} {'half' if half else 'float32'} {comp}: "
                f"{f.stat().st_size} B, decode {ms[True]:.3f} ms (C++) / "
                f"{ms[False]:.3f} ms (Python), equal bit for bit")
    blender = tmp / "p9_blender"
    (blender / "train").mkdir(parents=True)
    frames = []
    for i, k in enumerate(TRAIN_FRAMES):
        c2w = np.linalg.inv(frame_w2c(k))
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, as Blender stores them
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        rgba = np.concatenate([images[i], np.ones((H, W, 1))], -1)
        png.write_png(blender / f"train/r_{i}.png",
                      np.clip(rgba * 255 + 0.5, 0, 255).astype(np.uint8))
    fov = 2 * np.arctan(W / (2 * fx))
    (blender / "transforms_train.json").write_text(_json.dumps(
        {"camera_angle_x": fov, "frames": frames}))
    info, _, _ = scene.read_nerf_synthetic(blender, num_random_pts=20_000,
                                           device=dev)
    gb = GaussianModel.create_from_pcd(info.points, info.colors,
                                       max_sh_degree=0, device=dev)
    for k in kernels.values():
        k.launches = 0
    with torch.no_grad():
        out = driver.render(gb, info.cameras[0], backend="pallas")
    torch.cuda.synchronize()
    blender_launches = {k: v.launches for k, v in kernels.items()}
    pose_err = float(np.abs(info.poses_w2c - w2c).max())
    log(f"read_nerf_synthetic: {len(info.cameras)} cameras, "
        f"{len(info.points)} points, poses max|d| from the truth "
        f"{pose_err:.2e}; render of camera 0 {tuple(out.render.shape)} "
        f"finite {bool(torch.isfinite(out.render).all())}, launches "
        f"{blender_launches}")
    if not (len(info.cameras) == 3 and pose_err < 1e-9
            and bool(torch.isfinite(out.render).all())
            and blender_launches["KR"] == 1 and blender_launches["K1"] == 1):
        fail("Blender reader: cameras, poses, render or launches are off")
    part("EXR and Blender", t0)
    log(f"phase 9 [{smi}]: {time.time() - t_phase:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in seconds.items()))
    return launches


# --------------------------------------------------------------------------
# phase 10: MASt3R pre-training at full width
# --------------------------------------------------------------------------


def mast3r_pair_flops(cfg, h, w) -> dict:
    """Multiply-add operations x 2 of one forward of a view pair at h x w,
    by part, from the configuration's shapes (each matmul and conv counted
    as 2 x its MACs; softmax, norms and elementwise work left out)."""
    p = cfg.patch_size
    s = (h // p) * (w // p)  # tokens per view
    de, dd = cfg.enc_embed_dim, cfg.dec_embed_dim
    fd, ld = cfg.dpt_feature_dim, cfg.dpt_layer_dims
    conv3 = 2 * 9 * fd * fd  # a 3x3 fd -> fd conv, per output pixel
    enc = 2 * (2 * s * 3 * p * p * de  # patch embed
               + cfg.enc_depth * (24 * s * de * de + 4 * s * s * de))
    dec = 2 * (2 * s * de * dd  # decoder_embed
               + cfg.dec_depth * (32 * s * dd * dd + 8 * s * s * dd))
    dims = cfg.dpt_dim_tokens
    dpt = (2 * s * sum(a * b for a, b in zip(dims, ld))  # 1x1 projections
           + 2 * s * 16 * ld[0] * ld[0]  # k4 s4 transposed conv
           + 2 * s * 4 * ld[1] * ld[1]  # k2 s2 transposed conv
           + 2 * (s // 4) * 9 * ld[3] * ld[3]  # 3x3 stride-2 conv
           + 2 * 9 * fd * (16 * s * ld[0] + 4 * s * ld[1] + s * ld[2]
                           + (s // 4) * ld[3]))  # layer_rn 3x3 convs
    # fusion blocks: input at s/4, s, 4s, 16s pixels; residual units (two
    # 3x3 convs each; one unit without a skip), a 1x1 conv after the x2
    # upsample; the head's 3x3 fd -> last and 1x1 last -> 4 at 64s
    dpt += (conv3 * (2 * s // 4 + 4 * s + 4 * 4 * s + 4 * 16 * s)
            + 2 * fd * fd * (s + 4 * s + 16 * s + 64 * s)
            + 2 * 64 * s * (9 * fd * cfg.dpt_last_dim
                            + cfg.dpt_last_dim * 4))
    idim = de + dd
    n_out = (cfg.local_feat_dim + int(cfg.two_confs)) * p * p
    heads = 2 * (dpt + 2 * s * (idim * 4 * idim + 4 * idim * n_out))
    return {"encoder": enc, "decoder": dec, "heads": heads,
            "total": enc + dec + heads}


def pointmap_scale(model, batch) -> float:
    """max |pts3d| over both views of the first micro-batch of `batch`
    (stacked micro-batches), from a float32 forward without gradients."""
    import torch

    dev = next(model.parameters()).device
    with torch.no_grad():
        r1, r2 = model(batch["img1"][0].to(dev), batch["img2"][0].to(dev))
    return max(float(r1["pts3d"].abs().max()),
               float(r2["pts3d"].abs().max()))


@contextlib.contextmanager
def instrumented(trainer, prof_steps, tag, smi):
    """Wrap `trainer`'s step factory and checkpoint I/O over the block
    (the CLI and train_loop look them up in the module when they run):
    each optimizer step's synchronised ms, end time and loss, each save's
    and load's seconds; the steps numbered `prof_steps` (from 1, over the
    block) run under `profiled`, whose result lands in rec["profile"].
    Yields the record."""
    import torch

    rec = {"ms": [], "marks": [], "loss": [], "save": [], "load": [],
           "profile": {"busy_ms": 0.0, "events": 0}}
    names = ("make_dp_train_step", "save_pretrain_checkpoint",
             "load_pretrain_checkpoint")
    orig = {n: getattr(trainer, n) for n in names}
    window = contextlib.ExitStack()

    def make(*a, **kw):
        init, step, place = orig["make_dp_train_step"](*a, **kw)

        def timed(state, batch):
            k = len(rec["ms"]) + 1
            if k == prof_steps[0]:
                rec["profile"] = window.enter_context(profiled(
                    f"{tag} [{smi}]", "bf16", len(prof_steps), 12))
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            rec["ms"].append((time.perf_counter() - t) * 1e3)
            rec["loss"].append(float(metrics["loss"]))
            if k == prof_steps[-1]:
                window.close()
            rec["marks"].append(time.perf_counter())
            return state, metrics

        return init, timed, place

    def io(name):
        def run(*a, **kw):
            t = time.perf_counter()
            result = orig[f"{name}_pretrain_checkpoint"](*a, **kw)
            rec[name].append(time.perf_counter() - t)
            return result
        return run

    try:
        trainer.make_dp_train_step = make
        trainer.save_pretrain_checkpoint = io("save")
        trainer.load_pretrain_checkpoint = io("load")
        yield rec
    finally:
        window.close()
        for n, f in orig.items():
            setattr(trainer, n, f)


def stage_pretrain(host_model, tmp: Path, dev, smi: str):
    """Phase 10: MASt3R pre-training at full width. `host_model`: phase
    7's float32 random:0 ViT-L/BaseDecoder on the CPU (its numpy draw is
    not repeated). -> {kernel: launches} over the phase (all 0)."""
    import copy
    import itertools
    import statistics

    import numpy as np
    import torch

    from instantsplat_tpu_torch.cli import pretrain as pretrain_cli
    from instantsplat_tpu_torch.train_dust3r import losses, trainer
    from instantsplat_tpu_torch.train_dust3r.datasets import (
        PosedMultiViewDataset, write_synthetic_scene)

    t_phase = time.time()
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    cfg = host_model.cfg
    torch.cuda.empty_cache()

    # ---- (a) the data: posed RGBD scenes, PNG + .npy (no Pillow) ----
    root = tmp / "pretrain"
    write_synthetic_scene(root, name="scene0", n_views=PRETRAIN_VIEWS,
                          h=PRETRAIN_H, w=PRETRAIN_W, focal=0.8 * PRETRAIN_W)
    root224 = tmp / "pretrain224"
    write_synthetic_scene(root224, name="scene0", n_views=2, h=224, w=224,
                          focal=180.0)

    # ---- (b) one float32 micro-batch, card against CPU ----
    pair = next(PosedMultiViewDataset(
        root224, resolution=(224, 224), n_corres=256).batches(1, seed=0))
    objective = trainer._make_objective(cfg, losses.mast3r_finetune_loss,
                                        0.2, None)
    card_model = copy.deepcopy(host_model).to(dev)
    out = {}
    for name, model in (("card", card_model), ("cpu", host_model)):
        model.requires_grad_(True)
        t0 = time.time()
        loss, _ = objective(model, trainer.to_device(
            pair, next(model.parameters()).device))
        loss.backward()
        if name == "card":
            torch.cuda.synchronize()
        out[name] = (float(loss.detach()), {n: p.grad.detach().cpu()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None},
                     time.time() - t0)
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
    (lc, gc, sc), (lp, gp, sp) = out["card"], out["cpu"]
    loss_rel = abs(lc - lp) / abs(lp)
    norm_c = math.sqrt(sum(float((g.double() ** 2).sum())
                           for g in gc.values()))
    norm_p = math.sqrt(sum(float((g.double() ** 2).sum())
                           for g in gp.values()))
    leaf_err = {n: rel_l2(gc[n], gp[n]) for n in PRETRAIN_LEAVES}
    log(f"pretrain fp32 one pair 224x224 (mast3r_finetune, 256 "
        f"correspondences) [{smi}], card ({sc:.2f} s) against the CPU "
        f"({sp:.1f} s): "
        f"loss {lc:.6g} / {lp:.6g} (relative {loss_rel:.2e}, limit "
        f"{PRETRAIN_LOSS_RTOL:g}); gradient norm {norm_c:.6g} / {norm_p:.6g} "
        f"(relative {abs(norm_c - norm_p) / norm_p:.2e}); relative L2 "
        + ", ".join(f"{n} {v:.2e}" for n, v in leaf_err.items())
        + f" (limit {PRETRAIN_GRAD_RTOL:g})")
    if gc.keys() != gp.keys() or not gc:
        fail("pretrain: card and CPU reached different parameters")
    if not (loss_rel <= PRETRAIN_LOSS_RTOL and abs(norm_c - norm_p) / norm_p
            <= PRETRAIN_GRAD_RTOL and max(leaf_err.values())
            <= PRETRAIN_GRAD_RTOL):
        fail("pretrain fp32: the card's loss or gradients are off the CPU's")
    del gc, gp, out

    # ---- the pointmap scale the random head starts from ----
    n_pairs = PRETRAIN_BATCH * PRETRAIN_ACCUM
    flops = mast3r_pair_flops(cfg, PRETRAIN_H, PRETRAIN_W)
    train_flops = 3 * flops["total"] * n_pairs  # forward + backward
    ds = PosedMultiViewDataset(root, resolution=[(PRETRAIN_W, PRETRAIN_H)],
                               n_corres=PRETRAIN_CORRES,
                               transform="color_jitter")
    loader = ds.batches(PRETRAIN_BATCH, seed=7, n_epochs=PRETRAIN_EPOCHS)
    fixed = [trainer.stack_microbatches(list(
        itertools.islice(loader, PRETRAIN_ACCUM))) for _ in range(5)]
    scales = {"start": pointmap_scale(card_model, fixed[0])}
    kw = dict(PRETRAIN_HYPER, loss_fn=losses.mast3r_finetune_loss,
              accum_iter=PRETRAIN_ACCUM, total_steps=PRETRAIN_STEPS)

    # ---- (e) float32 speed: 8 steps without the loader's threads ----
    # the CLI's shape and schedule on five fixed batches, from the weights
    # the CLI starts from (the card's copy of (b)) and a fresh optimizer
    # state, as the CLI starts
    card_model.requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    init, step, _ = trainer.make_dp_train_step(cfg, compute_dtype=None, **kw)
    state = init(card_model)
    f32_ms, f32_loss = [], []
    for b in fixed + fixed[:3]:  # WARMUP eager, a capture, 4 replays
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, b)
        torch.cuda.synchronize()
        f32_ms.append((time.perf_counter() - t) * 1e3)
        f32_loss.append(float(met["loss"]))
    f32_peak = torch.cuda.max_memory_allocated() / 1e9
    del state, card_model, step, init  # the step's graph and its pool
    torch.cuda.empty_cache()
    med = statistics.median(f32_ms[-4:])
    log(f"pretrain fp32 (TF32 off) without the loader [{smi}]: "
        f"{len(f32_ms)} steps of {n_pairs} pairs at {PRETRAIN_W}x"
        f"{PRETRAIN_H}, ms " + ", ".join(f"{v:.1f}" for v in f32_ms)
        + f" (median of the last 4, replays: {med:.1f}; "
        f"{med / n_pairs:.1f} ms a pair; "
        f"{train_flops / (med / 1e3) / 1e12:.1f} TFLOP/s); losses "
        + ", ".join(f"{v:.4g}" for v in f32_loss)
        + f"; peak card memory {f32_peak:.2f} GB")
    if not np.isfinite(f32_loss).all():
        fail("pretrain fp32: a non-finite loss")

    # ---- (c) cli.pretrain, bf16, timed; (d) the resume to 25 ----
    pth = tmp / RANDOM0_PTH  # phase 7's random:0 weights
    out_dir = tmp / "pretrain_out"
    spec = (f"PosedMultiViewDataset('{root}', resolution=[({PRETRAIN_W}, "
            f"{PRETRAIN_H})], n_corres={PRETRAIN_CORRES}, "
            "transform='color_jitter')")
    # the learning rate, its warmup and the weight decay are the CLI's
    # defaults (PRETRAIN_HYPER)
    argv = ["--train_dataset", spec, "--criterion", "mast3r_finetune",
            "--bf16", "--batch_size", PRETRAIN_BATCH, "--accum_iter",
            PRETRAIN_ACCUM, "--steps", PRETRAIN_STEPS, "--num_workers", 4,
            "--epochs", PRETRAIN_EPOCHS, "--print_freq", 1, "--save_freq",
            10 * PRETRAIN_STEPS, "--pretrained", pth, "--output_dir",
            out_dir]
    with instrumented(trainer, PRETRAIN_PROFILED, "pretrain bf16 step",
                      smi) as rec:
        torch.cuda.reset_peak_memory_stats()
        # run_cli sets the counts to 0 for the CLI: keep the phase's so far
        before = {name: k.launches for name, k in kernels.items()}
        model, text, secs, launches, _ = run_cli(pretrain_cli.main, argv)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        cli_ms, cli_loss = rec["ms"][:], rec["loss"][:]
        marks, save_s = rec["marks"][:], rec["save"][:]
        scales[f"step {PRETRAIN_STEPS}"] = pointmap_scale(model, fixed[0])
        t0 = time.time()
        _, hist = trainer.train_loop(
            model, cfg, iter(fixed[:1] * PRETRAIN_STEPS + fixed),
            n_steps=PRETRAIN_RESUME_TO, log_every=1,
            output_dir=str(out_dir), compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        resume_s = time.time() - t0
    scales[f"step {PRETRAIN_RESUME_TO}"] = pointmap_scale(model, fixed[0])
    if len(cli_ms) != PRETRAIN_STEPS or len(save_s) != 1:
        fail(f"pretrain: the CLI ran {len(cli_ms)} timed optimizer steps and "
             f"{len(save_s)} saves, expected {PRETRAIN_STEPS} and 1")
    if len(rec["load"]) != 1 or len(rec["ms"]) != PRETRAIN_RESUME_TO:
        fail(f"pretrain resume: {len(rec['load'])} loads and "
             f"{len(rec['ms']) - PRETRAIN_STEPS} timed steps, expected 1 and "
             f"{PRETRAIN_RESUME_TO - PRETRAIN_STEPS}")
    if rec["profile"]["busy_ms"] <= 0:
        fail("pretrain: the profiler saw no device time in steps "
             f"{PRETRAIN_PROFILED}")

    ckpt = out_dir / "checkpoint-last.npz"
    tail = cli_ms[-PRETRAIN_TIMED:]
    med = statistics.median(tail)
    loop_ms = [(b - a) * 1e3 for a, b in zip(marks[-PRETRAIN_TIMED - 1:-1],
                                              marks[-PRETRAIN_TIMED:])]
    hist_line = [ln for ln in text.splitlines() if "done" in ln]
    log(f"pretrain cli.pretrain [{smi}]: {PRETRAIN_STEPS} steps of "
        f"{n_pairs} pairs ({PRETRAIN_BATCH} x accum {PRETRAIN_ACCUM}) "
        f"at {PRETRAIN_W}x{PRETRAIN_H}, bf16, mast3r_finetune with "
        f"{PRETRAIN_CORRES} correspondences, colour jitter, 4 workers, "
        f"steps {PRETRAIN_PROFILED[0]}-{PRETRAIN_PROFILED[-1]} profiled: "
        f"{secs:.1f} s in all; "
        f"{hist_line[0] if hist_line else 'no done line'}")
    log(f"pretrain step ms (synchronised, last {PRETRAIN_TIMED}) [{smi}]: "
        f"median "
        f"{med:.2f}, min {min(tail):.2f}, max {max(tail):.2f}; first "
        f"{cli_ms[0]:.1f}; loop ms per step (data included, last "
        f"{PRETRAIN_TIMED}) "
        f"median {statistics.median(loop_ms):.2f}, max {max(loop_ms):.2f}")
    log(f"pretrain FLOP (from the config, 2 x MACs of matmuls and "
        f"convs): forward of one {PRETRAIN_W}x{PRETRAIN_H} pair "
        f"{flops['total'] / 1e12:.3f} TFLOP (encoder "
        f"{flops['encoder'] / 1e12:.3f}, decoder "
        f"{flops['decoder'] / 1e12:.3f}, heads "
        f"{flops['heads'] / 1e12:.3f}); a step (3 x forward x "
        f"{n_pairs} pairs) {train_flops / 1e12:.2f} TFLOP")
    log(f"pretrain rates [{smi}]: {n_pairs / (med / 1e3):.1f} pairs/s, "
        f"{train_flops / (med / 1e3) / 1e12:.1f} TFLOP/s achieved "
        f"({100 * train_flops / (med / 1e3) / BF16_PEAK:.1f}% of the "
        f"989 TFLOP/s dense bf16 peak); peak card memory {peak_gb:.2f} "
        f"GB; checkpoint-last.npz {ckpt.stat().st_size / 1e9:.2f} GB "
        f"saved in {save_s[0]:.1f} s")
    if any(v for v in launches.values()):
        fail(f"pretrain launched compositor kernels: {launches}")
    if not ckpt.is_file():
        fail("pretrain: no checkpoint-last.npz")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail("pretrain: the masters are not float32")

    steps = [s for s, _ in hist]
    log(f"pretrain resume [{smi}]: checkpoint-last.npz loaded in "
        f"{rec['load'][0]:.1f} s, history steps {steps}, losses "
        + ", ".join(f"{m['loss']:.4g}" for _, m in hist)
        + f"; {resume_s:.1f} s with the save ({rec['save'][-1]:.1f} s)")
    if steps != list(range(PRETRAIN_STEPS + 1, PRETRAIN_RESUME_TO + 1)):
        fail(f"pretrain resume: history steps {steps}, expected "
             f"{PRETRAIN_STEPS + 1}..{PRETRAIN_RESUME_TO}")
    del model, fixed
    torch.cuda.empty_cache()

    # ---- the loss curve of the timed run and its resume ----
    first, last = cli_loss[0], cli_loss[-1]
    head, tail5 = np.mean(cli_loss[:5]), np.mean(cli_loss[-5:])
    log(f"pretrain loss [{smi}]: first {first:.6g}, last {last:.6g}; mean "
        f"of the first 5 {head:.6g}, of the last 5 {tail5:.6g}; every "
        f"step's loss finite: {bool(np.isfinite(rec['loss']).all())} "
        f"({len(rec['loss'])} steps, the profiled ones included)")
    log("pretrain pointmap scale (max |pts3d| of fixed batch 1, float32 "
        "forward): " + ", ".join(f"{k} {v:.4g}" for k, v in scales.items()))
    if not (np.isfinite(rec["loss"]).all() and last < first
            and tail5 < head):
        fail("pretrain: the loss did not fall or is not finite")
    launches = {name: before[name] + k.launches
                for name, k in kernels.items()}
    log(f"phase 10 [{smi}]: {time.time() - t_phase:.1f} s; compositor "
        f"launches {launches}")
    if any(launches.values()):
        fail(f"phase 10 launched compositor kernels: {launches}")
    return launches


# --------------------------------------------------------------------------
# phase 11: the multi-device layer
# --------------------------------------------------------------------------


def virtual_ranks(params, cam, dev, smi: str):
    """Phase 11 (a): every rank's local part of the sharded renders
    (parallel/sharding.py) run on this one card for world sizes
    P11_WORLDS, joined with the module's own join and merge code, and
    held to the one-device render: rgb and alpha within P11_IMAGE_ATOL,
    depth within P11_IMAGE_ATOL of its range, d(packed) within
    P11_GRAD_RTOL relative L2. Row blocks through KR/K1/K2 and through
    K3/K4 (capacities sized over the blocks), depth slices and the 2x2
    hybrid through KR/K1/K2."""
    import torch

    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops.rasterize import composite_out
    from instantsplat_tpu_torch.parallel import sharding as S
    from instantsplat_tpu_torch.render.driver import (prepare_packed_splats,
                                                       splat_valid)

    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            params, cam.pose, cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
            params.max_sh_degree, H, W)
    bg = torch.zeros(3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    cot = [torch.randn(shape, generator=gen, device=dev)
           for shape in ((H, W, 3), (H, W), (H, W))]

    def run(fn):
        """fn(packed) -> (rgb, alpha, depth); -> the three images and
        d(packed) of sum(image * cotangent)."""
        p = packed.clone().requires_grad_(True)
        out = fn(p)
        loss = sum((o * c).sum() for o, c in zip(out, cot))
        (d,) = torch.autograd.grad(loss, [p])
        return [o.detach() for o in out], d

    def one(p):
        return composite_out(*RP.composite_packed(p, H, W), bg)

    ref, ref_d = run(one)
    depth_range = float(ref[2].abs().max())

    def rows(backend, n):
        def fn(p):
            parts = [S.rows_local(p, r, n, H, W, backend) for r in range(n)]
            acc, tfin = S.join_rows(torch.stack([a for a, _ in parts]),
                                    torch.stack([t for _, t in parts]), H)
            return composite_out(acc, tfin, bg)
        return fn

    def slices(n):
        def fn(p):
            p = S.pad_slices(p, n)
            parts = [S.slice_local(p, r, n, H, W) for r in range(n)]
            return S.merge_depth_slices(torch.stack([a for a, _ in parts]),
                                        torch.stack([t for _, t in parts]),
                                        bg)
        return fn

    def hybrid(n_pix, n_gauss):
        def fn(p):
            p = S.pad_slices(p, n_gauss)
            blocks = []
            for pi in range(n_pix):
                parts = [S.tile_local(p, pi, n_pix, gi, n_gauss, H, W)
                         for gi in range(n_gauss)]
                rgb, alpha, depth = S.merge_depth_slices(
                    torch.stack([a for a, _ in parts]),
                    torch.stack([t for _, t in parts]), bg)
                blocks.append(torch.cat([rgb, alpha[..., None],
                                         depth[..., None]], -1))
            img = torch.cat(blocks)[:H]
            return img[..., :3], img[..., 3], img[..., 4]
        return fn

    def binned_caps(n):
        """pallas-binned:CF:DL holding every block's lists."""
        rows_n = S._padded_rows(H, n)
        caps = []
        for r in range(n):
            q = S._shift_rows(packed, float(r * rows_n))
            caps.append(RB.bin_requirements(q[:, :2], q[:, 2:5], q[:, 5],
                                            splat_valid(q), rows_n, W))
        cf, dl = map(max, zip(*caps))
        return f"pallas-binned:{cf}:{dl}"

    cases = []
    for n in P11_WORLDS:
        caps = binned_caps(n)
        cases += [(f"rows dense x{n}", rows("pallas", n)),
                  (f"rows {caps} x{n}", rows(caps, n)),
                  (f"depth slices x{n}", slices(n))]
    cases.append(("hybrid 2x2", hybrid(2, 2)))
    one_ms = cuda_ms(lambda: one(packed), 10)
    for tag, fn in cases:
        out, d = run(fn)
        e_rgb = float((out[0] - ref[0]).abs().max())
        e_alpha = float((out[1] - ref[1]).abs().max())
        e_depth = float((out[2] - ref[2]).abs().max())
        e_grad = rel_l2(d, ref_d)
        with torch.no_grad():
            ms = cuda_ms(lambda: fn(packed), 10)
        log(f"phase 11 virtual ranks {tag} [{smi}]: rgb max |d| "
            f"{e_rgb:.3e}, alpha {e_alpha:.3e}, depth {e_depth:.3e} (range "
            f"{depth_range:.3f}) against one device; d(packed) relative L2 "
            f"{e_grad:.3e}; all ranks' forwards + join {ms:.3f} ms in "
            f"sequence (one device {one_ms:.3f} ms)")
        if not (e_rgb <= P11_IMAGE_ATOL and e_alpha <= P11_IMAGE_ATOL
                and e_depth <= P11_IMAGE_ATOL * max(depth_range, 1.0)
                and e_grad <= P11_GRAD_RTOL):
            fail(f"phase 11 virtual ranks {tag}: differs from one device")


def parallel_rank(tmp: Path):
    """Phase 11 (b), in a child process started by `stage_parallel`: a
    one-rank NCCL group through the library entry points, each against
    its one-device run: train_joint(mesh=) for P11_TRAIN_ITERS iterations
    on each shard axis (the loss curve within LOSS_RTOL, phase 4's rule),
    refine_poses_sharded on phase 6's test views (P11_REFINE_ITERS steps;
    poses within 1e-3, losses within 1e-3 relative: K2's atomics), align
    (mesh=) on phase 7's oracle pairs (the card-against-CPU limits), and
    P11_PRETRAIN_STEPS float32 one-device, DDP and FSDP steps of the
    full-width MASt3R from phase 10's random:0 weights (losses within
    P11_PRETRAIN_RTOL), each a StepLoop (WARMUP eager steps, a capture,
    replays); FSDP's through `pretrain_one_step` (a replay against two
    eager steps, its replays free of host syncs, their ms, launch calls
    and peak memory). Writes the kernels' launch counts to
    <tmp>/phase11.json."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from instantsplat_tpu_torch.data.scene import read_scene
    from instantsplat_tpu_torch.init.aligner import GlobalAligner
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.parallel import (initialize_runtime,
                                                 make_mesh,
                                                 make_sharded_train_step)
    from instantsplat_tpu_torch.parallel.runtime import STORE_ENV
    from instantsplat_tpu_torch.pipelines.render_pipeline import (
        refine_poses_sharded)
    from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
    from instantsplat_tpu_torch.pipelines.trainer import (TrainerConfig,
                                                          train_joint)
    from instantsplat_tpu_torch.utils import transforms as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.time()
    initialize_runtime("cuda", init_method=f"file://{os.environ[STORE_ENV]}",
                       world_size=1, rank=0)
    mesh = make_mesh(1)
    dev = torch.device("cuda")
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    log(f"phase 11 one-rank NCCL group [{smi}]: up in {time.time() - t0:.1f}"
        f" s (backend {torch.distributed.get_backend()})")
    scene = tmp / "scene"

    # ---- train_joint on each shard axis against one device ----
    opt_cfg = OptimizationConfig(pp_optimizer=True, optim_pose=True)
    curves = {}
    for axis in (None, "pixels", "gaussians"):
        params, cams = initial_params(scene, dev)
        torch.cuda.synchronize()
        t = time.time()
        _, _, hist = train_joint(
            params, cams, opt_cfg=opt_cfg,
            trainer_cfg=TrainerConfig(iterations=P11_TRAIN_ITERS,
                                      backend="pallas", log_every=1,
                                      shard_axis=axis or "pixels"),
            mesh=None if axis is None else mesh)
        torch.cuda.synchronize()
        curves[axis] = np.array([m["loss"] for _, m in hist])
        log(f"phase 11 train_joint mesh={axis and 'one rank'} axis={axis} "
            f"[{smi}]: {P11_TRAIN_ITERS} iterations, "
            f"{(time.time() - t) / P11_TRAIN_ITERS * 1e3:.2f} ms/iter, loss "
            f"{curves[axis][0]:.5f} -> {curves[axis][-1]:.5f}")
    for axis in ("pixels", "gaussians"):
        d = float(np.max(np.abs(curves[axis] - curves[None]) / curves[None]))
        log(f"phase 11 train_joint {axis}: loss curve max relative "
            f"difference from one device {d:.3e} (limit {LOSS_RTOL})")
        if not (d <= LOSS_RTOL and curves[axis][-1] < curves[axis][0]):
            fail(f"phase 11 train_joint {axis}: off the one-device curve")
    # the card's busy share over sharded steps
    params, cams = initial_params(scene, dev)
    opt = GaussianOptimizer(opt_cfg, total_iterations=P11_TRAIN_ITERS)
    state = opt.init(params)
    step = make_sharded_train_step(opt, cams, torch.zeros(3, device=dev),
                                   0.2, mesh, backend="pallas")
    for i in range(3):
        float(step(params, state, i % 3, i + 1, 0)["loss"])
    with profiled("phase 11 sharded train step (one rank)", "pallas", 10,
                  top=6):
        for i in range(10):
            float(step(params, state, i % 3, i + 4, 0)["loss"])
    del params, state, opt

    # ---- refine_poses_sharded on phase 6's test views ----
    params, _ = load_trained(tmp / "dense", -1, sh_degree=3, device=dev)
    test = read_scene(scene, 3, split="test", device=dev)
    poses0 = T.matrix_to_pose_np(test.poses_w2c)
    gts = torch.stack([c.image for c in test.cameras])
    intr = torch.stack([torch.stack([c.fx, c.fy, c.cx, c.cy])
                        for c in test.cameras])
    got = {}
    for tag, m in (("sharded", mesh), ("per view", None)):
        torch.cuda.synchronize()
        t = time.time()
        got[tag] = refine_poses_sharded(
            params, test.cameras[0], poses0, gts, m, num_iter=P11_REFINE_ITERS,
            intrinsics=intr)
        secs = time.time() - t
        log(f"phase 11 refine_poses_sharded mesh={tag} [{smi}]: "
            f"{len(poses0)} views x {P11_REFINE_ITERS} steps in {secs:.2f} s "
            f"({secs / len(poses0) / P11_REFINE_ITERS * 1e3:.2f} ms a step)")
    dp = float(np.abs(got["sharded"][0] - got["per view"][0]).max())
    dl = float(np.max(np.abs(got["sharded"][1] - got["per view"][1])
                      / got["per view"][1]))
    log(f"phase 11 refine: poses max |d| {dp:.3e}, best losses max relative "
        f"{dl:.3e} (limits 1e-3)")
    if not (dp <= 1e-3 and dl <= 1e-3):
        fail("phase 11 refine_poses_sharded: differs from the per-view path")
    del params

    # ---- align(mesh=) on phase 7's oracle pairs ----
    preds = oracle_pointmap_fn(TRAIN_FRAMES, 0.9 * W)(
        None, make_pair_indices(3, "complete", symmetrize=True))
    res = {}
    for tag, m in (("sharded", mesh), ("one device", None)):
        al = GlobalAligner(preds, device=dev)
        al.init_mst(focal_avg=True)
        t = time.time()
        loss = al.align(niter=ALIGN_ITERS, mesh=m)
        res[tag] = (loss, al.get_im_poses())
        log(f"phase 11 align mesh={tag} [{smi}]: {ALIGN_ITERS} iterations, "
            f"{(time.time() - t) / ALIGN_ITERS * 1e3:.2f} ms each, loss "
            f"{loss:.6e}")
    d_loss = abs(res["sharded"][0] - res["one device"][0]) / \
        res["one device"][0]
    d_pose = float(np.abs(res["sharded"][1] - res["one device"][1]).max())
    log(f"phase 11 align: loss relative {d_loss:.3e} (limit "
        f"{ALIGN_LOSS_RTOL:g}), poses max |d| {d_pose:.3e} (limit "
        f"{ALIGN_POSE_ATOL:g})")
    if not (d_loss <= ALIGN_LOSS_RTOL and d_pose <= ALIGN_POSE_ATOL):
        fail("phase 11 align(mesh=): differs from one device")

    # ---- float32 DDP / FSDP steps of the full-width MASt3R ----
    mesh_pretrain(mast3r.build_trainable(str(tmp / RANDOM0_PTH),
                                         mast3r.MASt3RConfig(),
                                         device="cpu"), mesh, dev, smi)
    (tmp / "phase11.json").write_text(json.dumps(
        {name: k.launches for name, k in kernels.items()}))
    torch.distributed.destroy_process_group()


def mesh_pretrain(host, mesh, dev, smi):
    """Phase 11 (b)'s pre-training part: P11_PRETRAIN_STEPS float32 steps
    of `host` (the full-width MASt3R on the host) at P11_PRETRAIN_HW on
    one device, DDP and FSDP over `mesh` (one NCCL rank), each a StepLoop
    (WARMUP eager steps, a capture, replays); FSDP's through
    `pretrain_one_step` (a replay against two eager steps, later replays
    free of host syncs, their ms, launch calls and peak memory). The
    losses of DDP and FSDP within P11_PRETRAIN_RTOL of one device's."""
    import copy

    import torch

    from instantsplat_tpu_torch.train_dust3r import trainer as tt
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP

    cfg = host.cfg
    batches = [tt.synthetic_batch(cfg, batch=2, h=P11_PRETRAIN_HW,
                                  w=P11_PRETRAIN_HW, seed=s)
               for s in range(P11_PRETRAIN_STEPS)]
    losses, ms, peak = {}, {}, {}
    for tag, m in (("one device", None), ("DDP", mesh)):
        model = copy.deepcopy(host).to(dev)
        init, step_fn, _ = tt.make_dp_train_step(cfg, mesh=m)
        torch.cuda.reset_peak_memory_stats()
        state = init(model)
        held = torch.cuda.memory_allocated() / 1e9
        ms[tag] = []
        losses[tag] = []
        for b in batches:
            torch.cuda.synchronize()
            t = time.time()
            state, metrics = step_fn(state, b)
            losses[tag].append(float(metrics["loss"]))
            ms[tag].append((time.time() - t) * 1e3)
        peak[tag] = torch.cuda.max_memory_allocated() / 1e9
        log(f"phase 11 pretrain float32 {tag} [{smi}]: {P11_PRETRAIN_STEPS} "
            f"steps of 2 pairs at {P11_PRETRAIN_HW}x{P11_PRETRAIN_HW} "
            f"({WARMUP} eager, a capture, replays), ms "
            + ", ".join(f"{v:.1f}" for v in ms[tag]) + "; losses "
            + ", ".join(f"{v:.6g}" for v in losses[tag])
            + f"; card memory {held:.2f} GB after init_state, peak "
            f"{peak[tag]:.2f} GB")
        # the step function holds the state (and its graph) too
        del model, state, init, step_fn
        torch.cuda.empty_cache()
    # FSDP: the float32 one-step check (phase 13 (h)) over the mesh; its
    # first P11_PRETRAIN_STEPS steps take the batches above
    fsdp = pretrain_one_step(
        host, batches, dict(base_lr=1e-4, min_lr=1e-6, warmup_steps=100,
                            total_steps=10_000, mesh=mesh, fsdp=True),
        dev, smi, tag="phase 11 pretrain FSDP fp32", strict=True)
    losses["FSDP"] = fsdp["losses"][:P11_PRETRAIN_STEPS]
    fm = fsdp["ms"]
    log(f"phase 11 pretrain float32 FSDP [{smi}]: ms per step: eager "
        "warm-up " + ", ".join(f"{v:.1f}" for v in fm["warm-up"])
        + f", the capture's {fm['capture']:.1f}, replays "
        + ", ".join(f"{v:.1f}" for v in fm["replays"])
        + f" (each whole step under sync_debug_mode error; DDP's replay "
        f"{ms['DDP'][-1]:.1f}, one device's {ms['one device'][-1]:.1f}); "
        f"kernel launch API calls in a replayed step "
        f"{fsdp['launch_calls']} ({fsdp['graph_launches']} "
        f"cudaGraphLaunch); card memory {fsdp['peak']['state']:.2f} GB "
        f"after init_state, peak {fsdp['peak']['eager']:.2f} GB over the "
        f"eager warm-up, {fsdp['peak']['captured']:.2f} GB over the "
        f"capture and a replay (DDP {peak['DDP']:.2f}, one device "
        f"{peak['one device']:.2f}); losses "
        + ", ".join(f"{v:.6g}" for v in losses["FSDP"]))
    if fsdp["launch_calls"] or fsdp["graph_launches"] != 1:
        fail(f"phase 11 pretrain FSDP: a replayed step made "
             f"{fsdp['launch_calls']} kernel launch calls and "
             f"{fsdp['graph_launches']} graph launches (expected 0 and 1)")
    for tag in ("DDP", "FSDP"):
        d = max(abs(a - b) / abs(b) for a, b in
                zip(losses[tag], losses["one device"]))
        log(f"phase 11 pretrain {tag}: losses max relative difference from "
            f"one device {d:.3e} (limit {P11_PRETRAIN_RTOL:g})")
        if not d <= P11_PRETRAIN_RTOL:
            fail(f"phase 11 pretrain {tag}: off the one-device step")


def stage_parallel(scene: Path, tmp: Path, dev, smi: str):
    """Phase 11: the multi-device layer on the one card. (a)
    `virtual_ranks` on phase 4's model here; (b) `parallel_rank` in a
    child process (a one-rank NCCL group). -> launches {KR, K1..K6} of
    both."""
    import torch

    from instantsplat_tpu_torch.parallel import launch
    from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
    from instantsplat_tpu_torch.render import driver

    t_phase = time.time()
    driver._guard = driver._OverflowGuard()
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    params, _ = load_trained(tmp / "dense", -1, sh_degree=3, device=dev)
    _, cams = initial_params(scene, dev)
    virtual_ranks(params, cams[0], dev, smi)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase 11 (a) [{smi}]: {time.time() - t_phase:.1f} s; launches "
        f"{launches}")
    del params
    torch.cuda.empty_cache()

    t0 = time.time()
    try:
        launch.spawn("chip_smoke", ["--phase11-rank", str(tmp)], 1,
                     timeout=P11_LIMIT_S, cwd=str(REPO))
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 11 (b): {e}")
    child = json.loads((tmp / "phase11.json").read_text())
    log(f"phase 11 (b) [{smi}]: {time.time() - t0:.1f} s in the child "
        f"process; its launches {child}")
    launches = {k: launches[k] + child[k] for k in launches}
    log(f"phase 11 [{smi}]: {time.time() - t_phase:.1f} s; launches "
        f"{launches}")
    if any(launches[k] == 0 for k in ("KR", "K1", "K2", "K3", "K4")):
        fail(f"phase 11: a kernel of the sharded paths never launched "
             f"({launches})")
    return launches


# --------------------------------------------------------------------------
# phase 12: the structured entry points
# --------------------------------------------------------------------------


def stage_structured(scene: Path, tmp: Path, dev, smi: str):
    """Phase 12: the structured render path (the JAX package's drop-ins
    for rasterize.composite) on phase 4's dense model at the training
    shape. prepare_sorted_splats is bit-equal to prepare_packed_splats;
    composite_tiles' forward is bit-equal to composite_tiles_packed's and
    its gradients are the columns of the d(packed) its own K2 launch
    wrote (log-opacity zero on invalid rows); composite_tiles against
    rasterize.composite's plain path at phase 5's tolerances; structured
    composite_tiles_binned / composite_tiles_2d bit-equal in the forward
    to their packed twins; project_gaussians on the card against the CPU.
    -> launches {KR, K1..K6} of the phase."""
    import torch

    from instantsplat_tpu_torch.ops import projection, rasterize
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
    from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
    from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
    from instantsplat_tpu_torch.render import driver
    from instantsplat_tpu_torch.utils import transforms as T

    t_phase = time.time()
    driver._guard = driver._OverflowGuard()
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    params, _ = load_trained(tmp / "dense", -1, sh_degree=3, device=dev)
    cam = initial_params(scene, dev)[1][0]
    pose = cam.pose
    args = (params, pose, cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
            params.max_sh_degree, H, W)
    with torch.no_grad():
        splats, _ = driver.prepare_sorted_splats(*args)
        packed, _ = driver.prepare_packed_splats(*args)
    joined = torch.cat([splats[0], splats[1], splats[2][:, None], splats[3],
                        splats[4][:, None]], 1)
    valid = splats[5]
    n_valid = int(valid.sum())
    if not (torch.equal(joined, packed)
            and torch.equal(valid, packed[:, 9] < 1e30)):
        fail("phase 12: prepare_sorted_splats differs from "
             "prepare_packed_splats")
    log(f"phase 12 prepare_sorted_splats: N={packed.shape[0]} ({n_valid} "
        "valid) bit-equal to prepare_packed_splats")

    gen = torch.Generator(device=dev).manual_seed(12)
    cot = [torch.randn(shape, generator=gen, device=dev)
           for shape in ((H, W, 3), (H, W), (H, W))]
    cot[2] *= 1e-2  # depth cotangent at a scale like the colors'
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def loss_of(out):
        return sum((o * c).sum()
                   for o, c in zip((out.rgb, out.alpha, out.depth), cot))

    def structured(fn, **kw):
        """fn over leaf copies of the six arrays and bg -> (out, grads of
        the five float arrays and bg)."""
        leaves = [x.clone().requires_grad_(True) for x in splats[:5]]
        b = bg.clone().requires_grad_(True)
        out = fn(*leaves, valid, H, W, b, **kw)
        return out, torch.autograd.grad(loss_of(out), leaves + [b])

    def packed_twin(fn, *caps):
        p = packed.clone().requires_grad_(True)
        out = fn(p, H, W, bg, *caps)
        return out, torch.autograd.grad(loss_of(out), [p])[0]

    def same_forward(a, b):
        return all(torch.equal(getattr(a, n), getattr(b, n))
                   for n in ("rgb", "alpha", "depth"))

    # composite_tiles: the d(packed) of its own K2 launch, recorded
    k2_out = []
    k2 = RP.k2_backward

    def recording_k2(*a):
        k2_out.append(k2(*a))
        return k2_out[-1]

    RP.k2_backward = recording_k2
    try:
        out_s, grads_s = structured(RP.composite_tiles)
    finally:
        RP.k2_backward = k2
    out_p, d_packed = packed_twin(RP.composite_tiles_packed)
    if not same_forward(out_s, out_p):
        fail("phase 12: composite_tiles' forward differs from "
             "composite_tiles_packed's")
    (d_own,) = k2_out
    columns = (slice(0, 2), slice(2, 5), 5, slice(6, 9), 9)
    for name, g, col in zip(("mean2d", "conic", "log_opacity", "colors",
                             "depth"), grads_s, columns):
        want = d_own[:, col]
        if name == "log_opacity":
            want = torch.where(valid, want, torch.zeros_like(want))
        if not (torch.isfinite(g).all() and torch.equal(g, want)):
            fail(f"phase 12 composite_tiles: d({name}) is not its columns "
                 "of d(packed)")
    e_twin = rel_l2(d_own, d_packed)
    log(f"phase 12 composite_tiles: forward bit-equal to "
        f"composite_tiles_packed; each input's gradient equals its columns "
        f"of d(packed) (log-opacity zero on the {packed.shape[0] - n_valid} "
        f"invalid rows); d(packed) relative L2 to the packed call's own "
        f"backward {e_twin:.3e} (K2 adds with atomics)")
    if e_twin > 1e-5:
        fail("phase 12 composite_tiles: d(packed) differs from the packed "
             "call's")

    # against rasterize.composite's plain path
    t0 = time.time()
    out_r, grads_r = structured(rasterize.composite)
    plain_s = time.time() - t0
    errs = {n: float((getattr(out_s, n) - getattr(out_r, n)).detach()
                     .abs().max()) for n in ("rgb", "alpha", "depth")}
    e_grad = rel_l2(torch.cat([g.reshape(-1) for g in grads_s]),
                    torch.cat([g.reshape(-1) for g in grads_r]))
    log(f"phase 12 composite_tiles against rasterize.composite (plain, "
        f"{plain_s:.1f} s forward + backward) [{smi}]: max |d| "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
        + f"; gradients relative L2 {e_grad:.3e}")
    if max(errs.values()) > 5e-4 or not e_grad <= 1e-3:
        fail("phase 12: composite_tiles differs from rasterize.composite "
             "beyond 5e-4 (image) / 1e-3 (gradient)")

    # the structured list compositors against their packed twins
    cols4 = (splats[0], splats[1], splats[2], valid)
    lists = {
        "binned": (RB.composite_tiles_binned,
                   RB.composite_tiles_binned_packed,
                   dict(zip(("cap_factor", "d_levels"),
                            RB.bin_requirements(*cols4, H, W)))),
        "tiled": (RT.composite_tiles_2d, RT.composite_tiles_2d_packed,
                  dict(zip(("cap_factor", "dy_levels", "dx_levels"),
                           RT.tile_requirements(*cols4, H, W))))}
    for kind, (fn, twin, caps) in lists.items():
        out_l, grads_l = structured(fn, **caps)
        out_t, d_t = packed_twin(twin, *caps.values())
        if not same_forward(out_l, out_t):
            fail(f"phase 12 {fn.__name__}: forward differs from "
                 f"{twin.__name__}")
        e_l = rel_l2(torch.cat([grads_l[0], grads_l[1], grads_l[3]], 1),
                     torch.cat([d_t[:, 0:5], d_t[:, 6:9]], 1))
        log(f"phase 12 {fn.__name__} {caps}: forward bit-equal to "
            f"{twin.__name__}; mean2d/conic/colors gradients relative L2 "
            f"{e_l:.3e} to the packed call's (atomics)")
        if e_l > 1e-5:
            fail(f"phase 12 {fn.__name__}: gradients differ from "
                 f"{twin.__name__}'s")
    leaves = [x.clone().requires_grad_(True) for x in splats[:5]]
    p = packed.clone().requires_grad_(True)
    fwd_bwd_ms = {
        "composite_tiles": cuda_ms(lambda: torch.autograd.grad(loss_of(
            RP.composite_tiles(*leaves, valid, H, W, bg)), leaves), 10),
        "composite_tiles_packed": cuda_ms(lambda: torch.autograd.grad(
            loss_of(RP.composite_tiles_packed(p, H, W, bg)), [p]), 10)}
    log(f"phase 12 forward + backward ms [{smi}]: " + ", ".join(
        f"{k} {v:.3f}" for k, v in fwd_bwd_ms.items()))

    # project_gaussians on the card against the CPU
    with torch.no_grad():
        geo = (params.xyz, params.get_covariance(),
               T.quat_to_rotmat(pose[:4]), pose[4:],
               cam.fx, cam.fy, cam.cx, cam.cy)
        on_card = projection.project_gaussians(*geo, W, H)
        on_cpu = projection.project_gaussians(*(x.cpu() for x in geo), W, H)
    both = on_card.valid.cpu() & on_cpu.valid
    agree = float((on_card.valid.cpu() == on_cpu.valid).float().mean())

    def rel(a, b):
        return float((a[both] - b[both]).abs().max() / b[both].abs().max())

    # The conic inverts cov2d: a*c - b*b cancels, so the cov2d's ~1e-7
    # difference (cuBLAS against the CPU's einsum order) grows by the 2x2's
    # condition number. The card's conic is judged as the inverse of the
    # card's cov2d, computed on the CPU, beside cov2d against the CPU.
    a, b, c = on_card.cov2d.cpu().unbind(-1)
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det <= 0, torch.ones_like(det), det)
    e_proj = {name: rel(getattr(on_card, name).cpu(), getattr(on_cpu, name))
              for name in ("mean2d", "cov2d", "depth")}
    e_proj["conic (of the card's cov2d)"] = rel(
        on_card.conic.cpu(), torch.stack([c, -b, a], -1) * inv_det[:, None])
    log(f"phase 12 project_gaussians card against CPU: valid agree on "
        f"{agree * 100:.4f}%; max |d| / max |CPU| " + ", ".join(
            f"{n} {e:.3e}" for n, e in e_proj.items())
        + f"; conic against the CPU's {rel(on_card.conic.cpu(), on_cpu.conic):.3e}")
    if agree < 0.9999 or max(e_proj.values()) > 1e-5:
        fail("phase 12: project_gaussians differs on the card beyond 1e-5")

    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    log(f"phase 12 [{smi}]: {time.time() - t_phase:.1f} s; launches "
        f"{launches}")
    if any(n == 0 for n in launches.values()):
        fail(f"phase 12: a kernel of the structured entries never launched "
             f"({launches})")
    return launches


# --------------------------------------------------------------------------
# phase 13: the device-resident loops (captured CUDA graphs)
# --------------------------------------------------------------------------


@contextlib.contextmanager
def eager_loops():
    """Every StepLoop steps as a Python loop on the card too: the same step
    launched op by op (the eager comparison of the captured loops)."""
    from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop

    old = StepLoop.captured
    StepLoop.captured = property(lambda self: False)
    try:
        yield
    finally:
        StepLoop.captured = old


@contextlib.contextmanager
def eager_training():
    """cli.train with TrainerConfig(scan=False): train_step per iteration,
    as the JAX trainer steps with scan off."""
    import functools

    from instantsplat_tpu_torch.cli import train as train_cli

    old = train_cli.TrainerConfig
    train_cli.TrainerConfig = functools.partial(old, scan=False)
    try:
        yield
    finally:
        train_cli.TrainerConfig = old


def api_profile(fn, iters: int):
    """fn() (`iters` iterations, ends synchronised) under torch.profiler.
    -> dict(api: {runtime API name: calls}, kernels: {device kernel name:
    launches}, kernel_ms: {device kernel name: ms}, busy_ms, wall_ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    api, kernels, kernel_ms, busy = {}, {}, {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0) + 1
            ms = e.time_range.elapsed_us() / 1e3
            kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + ms
            busy += ms
        elif e.name.startswith(("cuda", "cu")):
            api[e.name] = api.get(e.name, 0) + 1
    return dict(api=api, kernels=kernels, kernel_ms=kernel_ms, busy_ms=busy,
                wall_ms=wall_ms)


def launch_calls(api) -> int:
    """Kernel launch API calls among the runtime calls `api` recorded."""
    return sum(n for name, n in api.items()
               if name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                           "cuLaunchKernel", "cuLaunchKernelEx"))


def synced_ms(fn, iters: int) -> float:
    """ms per iteration of fn() (`iters` iterations), host clock between
    two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def stage_graphs(scene: Path, tmp: Path, captured: dict, explicit: dict,
                 host_model, dev, smi: str):
    """Phase 13: stage 2, the pose refiner and the aligner as replays of
    captured CUDA graphs (the default) against their eager loops, in one
    call, on phase 4's scene and its first dense run's model; then (g)
    sparse alignment's two phases, (h) the full-width pre-training step
    from `host_model` (phase 7's float32 random:0 MASt3R on the host) and
    (i) train_joint and align over a one-rank NCCL mesh, each captured
    against eager. `captured`: phase 4's runs by backend (history, steady
    ms/iter, graph replays); `explicit`: phase 4's tiled and binned
    strings. -> launches {KR, K1..K6} of the phase."""
    import torch

    from instantsplat_tpu_torch.init.aligner import GlobalAligner
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.models.camera import stack_cameras
    from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
    from instantsplat_tpu_torch.opt.gaussian_opt import (
        GaussianOptimizer, OptimizationConfig)
    from instantsplat_tpu_torch.data.scene import read_scene
    from instantsplat_tpu_torch.pipelines.render_pipeline import (
        make_pose_refiner)
    from instantsplat_tpu_torch.pipelines.train_pipeline import load_trained
    from instantsplat_tpu_torch.pipelines.trainer import (make_train_scan,
                                                          train_step)
    from instantsplat_tpu_torch.render import driver
    from instantsplat_tpu_torch.utils import transforms as T
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    t_phase = time.time()
    kernels = kernel_table()
    phase = {name: 0 for name in kernels}

    # ---- (a) cli.train eager (scan=False) against phase 4's captured runs
    for kind, backend in (("dense", "pallas"), ("auto", "auto"),
                          ("tiled", explicit["tiled"]),
                          ("binned", explicit["binned"])):
        hist_c, steady_c, replays_c = captured[kind]
        with eager_training():
            _, history, launches, secs, _, dem, replays = train_run(
                scene, tmp / f"eager_{kind}", backend,
                10 if kind == "auto" else 1)
        for k in phase:
            phase[k] += launches[k]
        steady_e = check_run(f"{kind} eager (scan=False)", history,
                             launches, secs, dem, 10 if kind == "auto"
                             else 1, {it: m["loss"] for it, m in hist_c})
        fwd = sum(launches[k] for k in ("K1", "K3", "K5"))
        if replays or fwd != TRAIN_ITERS or launches["KR"] != TRAIN_ITERS:
            fail(f"phase 13 {kind} eager: {replays} graph replays, "
                 f"launches {launches}")
        log(f"phase 13 {kind} [{smi}]: steady ms/iter captured "
            f"{steady_c:.2f} ({replays_c} graph replays of {TRAIN_ITERS} "
            f"iterations) against eager {steady_e:.2f}")

    # ---- (b)-(d) the training step at the training shape ------------------
    params, _ = load_trained(tmp / "dense", TRAIN_ITERS, device=dev)
    p0, cams = initial_params(scene, dev)  # the trained Gaussians, and
    params = params.replace(cam_poses=p0.cam_poses)  # poses to learn
    del p0
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True),
                            total_iterations=TRAIN_ITERS)
    state = opt.init(params)
    stacked = stack_cameras(cams)
    bg = torch.zeros(3, device=dev)

    def snapshot():
        return ({f: getattr(params, f).clone() for f in PARAM_FIELDS},
                {f: state.m[f].clone() for f in PARAM_FIELDS},
                {f: state.v[f].clone() for f in PARAM_FIELDS}, state.step)

    def restore(snap):
        for f in PARAM_FIELDS:
            getattr(params, f).copy_(snap[0][f])
            state.m[f].copy_(snap[1][f])
            state.v[f].copy_(snap[2][f])
        state.step = snap[3]

    s0 = snapshot()
    n_prof, n_time = 10, 30  # cut from 20, 50 for the time limit
    for kind, backend in (("dense", "pallas"), ("tiled", explicit["tiled"]),
                          ("binned", explicit["binned"])):
        driver._guard = driver._OverflowGuard()
        restore(s0)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        block = make_train_scan(opt, stacked, bg, 0.2, backend, 256)
        block(params, state, [0] * (WARMUP + 1), range(1, WARMUP + 2), 0)
        # (b) one step from the same state, captured against eager: the
        # parameters and the first moments (0.1 x the gradient) by
        # relative L2 (Adam's first step moves a parameter by +-lr
        # whatever its gradient's size, so a gradient at the rounding
        # floor, which K2's atomics flip, moves it by 2 lr either way)
        restore(s0)
        block(params, state, [0], [1], 0)
        one = snapshot()
        eager = []
        for _ in range(2):
            restore(s0)
            train_step(params, cams[0], opt, state, 1, 0, bg, 0.2, backend,
                       256)
            eager.append(snapshot())
        def rel(a, b):  # relative L2; absolute where b is all zero
            n = float(torch.linalg.norm(b.double()))
            return float(torch.linalg.norm((a - b).double())) / (n or 1.0)

        worst = 0.0
        for part, label in ((0, ""), (1, "first moment of ")):
            for f in PARAM_FIELDS:
                spread = rel(eager[1][part][f], eager[0][part][f])
                d = rel(one[part][f], eager[0][part][f])
                tol = 2 * spread + 1e-6
                worst = max(worst, d / tol)
                if not d <= tol:
                    fail(f"phase 13 {kind}: one captured step differs from "
                         f"an eager one in {label}{f} by {d:.3e} relative "
                         f"L2 (eager spread {spread:.3e})")
        # (c) runtime calls, device launches and the busy share, 20 steps
        views = [i % len(cams) for i in range(n_time)]
        restore(s0)
        before = StepLoop.replays
        cap = api_profile(lambda: block(params, state, views[:n_prof],
                                        range(2, n_prof + 2), 0), n_prof)
        replayed = StepLoop.replays - before
        graph_calls = cap["api"].get("cudaGraphLaunch", 0)
        if replayed != n_prof or (cap["api"] and graph_calls != n_prof):
            fail(f"phase 13 {kind}: {replayed} replays counted, "
                 f"{graph_calls} cudaGraphLaunch calls seen, for {n_prof} "
                 "iterations")
        restore(s0)
        table = to_cuda_rows(opt, range(2, n_prof + 2), state.step + 1, dev)

        def eager_steps(n, first=2):
            for j in range(n):
                train_step(params, cams[views[j]], opt, state, first + j, 0,
                           bg, 0.2, backend, 256, scalars=table[j % n_prof])

        eag = api_profile(lambda: eager_steps(n_prof), n_prof)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # (d) ms/iter, synchronised, no profiler
        restore(s0)
        ms_c = synced_ms(lambda: block(params, state, views,
                                       range(2, n_time + 2), 0), n_time)
        restore(s0)
        ms_e = synced_ms(lambda: eager_steps(n_time), n_time)
        for k, kern in kernels.items():
            phase[k] += kern.launches
        busy = {t: p["busy_ms"] / n_prof for t, p in (("captured", cap),
                                                      ("eager", eag))}
        share = {t: 100 * p["busy_ms"] / p["wall_ms"] for t, p in (
            ("captured", cap), ("eager", eag))}
        calls = {t: launch_calls(p["api"]) / n_prof for t, p in (
            ("captured", cap), ("eager", eag))}
        log(f"phase 13 {kind} step ({backend}) [{smi}]: ms/iter "
            f"synchronised over {n_time}: captured {ms_c:.3f}, eager "
            f"{ms_e:.3f} ({ms_e / ms_c:.2f}x); kernel launch API calls per "
            f"iteration captured {calls['captured']:.1f}, eager "
            f"{calls['eager']:.1f}; cudaGraphLaunch {graph_calls} for "
            f"{n_prof} iterations; device busy per iteration captured "
            f"{busy['captured']:.3f} ms = {share['captured']:.1f}% of the "
            f"wall, eager {busy['eager']:.3f} ms = {share['eager']:.1f}% "
            f"(profiler on); peak memory {peak_gb:.2f} GB; one captured "
            f"step against eager: worst {worst:.3f} of its limit")
        for tag, prof in (("captured", cap), ("eager", eag)):
            log(f"phase 13 {kind} {tag}: runtime API calls per iteration: "
                + ", ".join(f"{name} {n / n_prof:.1f}" for name, n in sorted(
                    prof["api"].items(), key=lambda kv: -kv[1])[:6]))
        for name, n in sorted(cap["kernels"].items(), key=lambda kv: -kv[1]):
            if any(k in name for k in ("k1_", "k2_", "lists_")):
                log(f"phase 13 {kind} captured: device launches of "
                    f"{name[:60]}: {n} in {n_prof} iterations")
        if not cap["kernels"]:
            log(f"phase 13 {kind}: torch.profiler recorded no device "
                "events inside the graph replays (busy share not measured)")
    restore(s0)
    del state

    # ---- (e) the pose refiner on phase 6's test views ----------------------
    driver._guard = driver._OverflowGuard()
    for k in kernels.values():
        k.launches = 0
    test = read_scene(scene, 3, split="test", device=dev)
    n_ref = 100
    refine = make_pose_refiner(params, test.cameras[0], num_iter=n_ref)
    pose0 = T.matrix_to_pose_np(test.poses_w2c)
    refine(pose0[0], test.cameras[0].image)  # warm-up and capture
    before = StepLoop.replays

    def refine_views(fn, views):
        for i in views:
            c = test.cameras[i]
            fn(pose0[i], c.image, intr=(c.fx, c.fy, c.cx, c.cy))

    ms_ref_c = synced_ms(lambda: refine_views(refine, range(4)), 4 * n_ref)
    if StepLoop.replays - before != 4 * n_ref:
        fail(f"phase 13 refiner: {StepLoop.replays - before} replays for "
             f"{4 * n_ref} steps")
    with eager_loops():
        eager_refine = make_pose_refiner(params, test.cameras[0],
                                         num_iter=n_ref)
        ms_ref_e = synced_ms(lambda: refine_views(eager_refine, range(2)),
                             2 * n_ref)
    for k, kern in kernels.items():
        phase[k] += kern.launches
    log(f"phase 13 refiner [{smi}]: ms per refinement step on phase 6's "
        f"views: captured {ms_ref_c:.3f} (4 views x {n_ref}), eager "
        f"{ms_ref_e:.3f} (2 views x {n_ref}), {ms_ref_e / ms_ref_c:.2f}x")
    del params

    # ---- (f) the aligner on phase 7's oracle pairs -------------------------
    preds = oracle_pointmap_fn(TRAIN_FRAMES, 0.9 * W)(
        None, make_pair_indices(3, "complete", symmetrize=True))
    align_ms = {}
    for tag in ("captured", "eager"):
        ctx = eager_loops() if tag == "eager" else contextlib.nullcontext()
        with ctx:
            secs = {}
            for n in (0, ALIGN_ITERS):
                a = GlobalAligner(preds, device=dev)
                a.init_mst(focal_avg=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = a.align(niter=n)
                secs[n] = time.perf_counter() - t0
                if not math.isfinite(loss):
                    fail(f"phase 13 aligner {tag}: loss {loss}")
            align_ms[tag] = (secs[ALIGN_ITERS] - secs[0]) * 1e3 / ALIGN_ITERS
    log(f"phase 13 aligner [{smi}]: {ALIGN_ITERS} iterations on 6 oracle "
        f"pairs at {W}x{H}: captured {align_ms['captured']:.3f} ms per "
        f"iteration, eager {align_ms['eager']:.3f} "
        f"({align_ms['eager'] / align_ms['captured']:.2f}x; the first "
        f"{WARMUP} steps and the capture included)")
    # ---- (g)-(i) the loops of slice 13 ------------------------------------
    for k in kernels.values():
        k.launches = 0
    t0 = time.time()
    graphs_sparse(dev, smi)
    log(f"phase 13 (g) [{smi}]: {time.time() - t0:.1f} s")
    t0 = time.time()
    graphs_pretrain(host_model, tmp, dev, smi)
    log(f"phase 13 (h) [{smi}]: {time.time() - t0:.1f} s")
    for k, kern in kernels.items():
        phase[k] += kern.launches
    torch.cuda.empty_cache()
    for k, n in graphs_mesh(tmp, smi).items():
        phase[k] += n
    log(f"phase 13 [{smi}]: {time.time() - t_phase:.1f} s; launches {phase}")
    if not (phase["KR"] and phase["K1"] and phase["K2"] and phase["K3"]
            and phase["K5"]):
        fail(f"phase 13: a kernel of the captured paths never launched "
             f"({phase})")
    return phase


def read_trace(logdir: Path, blocks: int) -> dict:
    """The trace that TrainerConfig.profile_dir left in `logdir` (blocks
    of `blocks` iterations; block 1 traced): its files, size, events,
    whether block 1's and block 0's `annotate` spans are in it, and its
    kernel events of KR, K1 and K2."""
    files = sorted(logdir.glob("*.pt.trace.json"))
    if len(files) != 1:
        return dict(files=len(files))
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    return dict(
        files=1, mb=files[0].stat().st_size / 1e6, events=len(events),
        block1=f"train_joint block {blocks + 1}-{2 * blocks}" in names,
        block0=f"train_joint block 1-{blocks}" in names,
        kernels={k: sum(f"{k}_kernel" in str(e.get("name", ""))
                        for e in events if e.get("cat") == "kernel")
                 for k in ("k1_rects", "k1_forward", "k2_backward")})


def check_trace(trace: dict, blocks: int, smi: str):
    """Phase 13 (i)'s profile_dir run: one trace file holding block 1's
    span and K1's and K2's kernels once an iteration, nothing of block
    0."""
    log(f"phase 13 profile_dir (train_joint over the mesh, block 1 traced) "
        f"[{smi}]: {trace}")
    k = trace.get("kernels", {})
    if not (trace["files"] == 1 and trace["block1"] and not trace["block0"]
            and k["k1_forward"] == blocks and k["k2_backward"] == blocks):
        fail("phase 13 profile_dir: the trace lacks block 1's span or K1's "
             "and K2's launches, or holds block 0")


@contextlib.contextmanager
def loop_profiles(k: int):
    """Each StepLoop.run of more than WARMUP + 1 + k steps runs its first
    WARMUP + 1 steps (the warm-up and the capture, or eager steps), then
    k steps under api_profile (replays of the graph, or eager steps),
    then the rest. Never a capture under the profiler. Yields {loop name:
    [api_profile of k steps, ...]}."""
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    out: dict = {}
    real = StepLoop.run

    def run(self, n):
        if n <= WARMUP + 1 + k:
            return real(self, n)
        res = real(self, WARMUP + 1)
        out.setdefault(self.name, []).append(
            api_profile(lambda: real(self, k), k))
        rest = n - WARMUP - 1 - k
        return real(self, rest) if rest else res

    StepLoop.run = run
    try:
        yield out
    finally:
        StepLoop.run = real


def loop_line(tag, smi, unit, ms, profs, peak, diff, limit, what):
    """Print one captured-against-eager comparison and check it: `ms`,
    `profs` ({captured, eager}: api_profile dicts of k iterations with
    "k" added), `peak` ({captured, eager}: GB), `diff` the largest
    difference between the two runs' results (`what`) and its `limit`.
    Fails unless the captured run made one cudaGraphLaunch per
    iteration (the profiler saw the runtime's calls) and diff <= limit."""
    calls, graphs, busy, share = {}, {}, {}, {}
    for mode, prof in profs.items():
        k = prof["k"]
        calls[mode] = launch_calls(prof["api"]) / k
        graphs[mode] = prof["api"].get("cudaGraphLaunch", 0) / k
        busy[mode] = prof["busy_ms"] / k
        share[mode] = 100 * prof["busy_ms"] / prof["wall_ms"]
    log(f"phase 13 {tag} [{smi}]: ms per {unit} captured {ms['captured']:.3f}"
        f", eager {ms['eager']:.3f} ({ms['eager'] / ms['captured']:.2f}x); "
        f"kernel launch API calls per {unit} captured "
        f"{calls['captured']:.1f}, eager {calls['eager']:.1f}; "
        f"cudaGraphLaunch per {unit} captured {graphs['captured']:.2f}, "
        f"eager {graphs['eager']:.2f}; device busy per {unit} captured "
        f"{busy['captured']:.3f} ms = {share['captured']:.1f}% of the wall, "
        f"eager {busy['eager']:.3f} ms = {share['eager']:.1f}% (profiler "
        f"on, {profs['captured']['k']} and {profs['eager']['k']} {unit}s); "
        f"peak memory captured {peak['captured']:.2f} GB, eager "
        f"{peak['eager']:.2f} GB; {what}: {diff:.3e} (limit {limit:g})")
    if profs["captured"]["api"] and graphs["captured"] != 1:
        fail(f"phase 13 {tag}: {graphs['captured']} cudaGraphLaunch calls "
             f"per {unit} captured")
    if not profs["captured"]["kernels"]:
        log(f"phase 13 {tag}: torch.profiler recorded no device events "
            "inside the replays (busy share not measured)")
    top = sorted(profs["captured"]["kernel_ms"].items(),
                 key=lambda kv: -kv[1])[:4]
    if top:
        log(f"phase 13 {tag}: the most device time per {unit} captured: "
            + "; ".join(f"{ms / profs['captured']['k']:.3f} ms "
                        f"{100 * ms / profs['captured']['busy_ms']:.1f}% "
                        f"{name[:70]}" for name, ms in top))
    if not diff <= limit:
        fail(f"phase 13 {tag}: captured and eager differ by {diff:.3e} "
             f"({what}; limit {limit:g})")


def graphs_sparse(dev, smi):
    """Phase 13 (g): both sparse-alignment phases captured against eager
    on phase 9's oracle inputs (P13_SPARSE_ITERS + P13_SPARSE_ITERS
    iterations): coarse and fine ms per Adam iteration, launches, busy
    share, peak memory, the results' c2w and loss."""
    import numpy as np
    import torch

    from instantsplat_tpu_torch.init.sparse_align import (
        sparse_global_alignment)
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    preds, _, _ = sparse_oracle()
    matches, _ = timed_matches(preds, dev)
    res, ms, profs, peak = {}, {}, {}, {}
    for mode in ("captured", "eager"):
        ctx = eager_loops() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            before = StepLoop.replays
            torch.cuda.reset_peak_memory_stats()
            res[mode], coarse, fine = timed_alignment(
                f"phase 13 sparse {mode} [{smi}]", preds, matches, dev,
                P13_SPARSE_ITERS)
            peak[mode] = torch.cuda.max_memory_allocated() / 1e9
            ms[mode] = dict(coarse=coarse, fine=fine)
            replays = StepLoop.replays - before
            want = 3 * (P13_SPARSE_ITERS - WARMUP) if mode == "captured" \
                else 0
            if replays != want:
                fail(f"phase 13 sparse {mode}: {replays} replays, expected "
                     f"{want}")
            n = WARMUP + 1 + P13_PROFILED + 1  # each phase profiled inside
            with loop_profiles(P13_PROFILED) as got:
                sparse_global_alignment(preds, matches=matches,
                                        subsample=SPARSE_SUBSAMPLE,
                                        niter1=n, niter2=n, device=dev)
            profs[mode] = {name: dict(runs[0], k=P13_PROFILED)
                           for name, runs in got.items()}
    d_c2w = float(np.abs(res["captured"].c2w - res["eager"].c2w).max())
    d_loss = abs(res["captured"].loss - res["eager"].loss) / abs(
        res["eager"].loss)
    for phase in ("coarse", "fine"):
        name = f"sparse_align {phase}"
        loop_line(f"sparse alignment {phase} phase ({P13_SPARSE_ITERS} "
                  f"iterations, 3 oracle views at {W}x{H})", smi,
                  "iteration", {m: ms[m][phase] for m in ms},
                  {m: profs[m][name] for m in profs}, peak, d_c2w,
                  SPARSE_POSE_ATOL, f"c2w max |d| after {P13_SPARSE_ITERS}"
                  f" + {P13_SPARSE_ITERS}")
    log(f"phase 13 sparse alignment: final loss captured "
        f"{res['captured'].loss:.6e}, eager {res['eager'].loss:.6e} "
        f"(relative {d_loss:.3e})")


def pretrain_one_step(host_model, fixed, kw, dev, smi,
                      tag="phase 13 pretrain fp32", strict=False):
    """Phase 13 (h), float32 (and phase 11 (b)'s FSDP step over a mesh,
    with `kw` holding mesh= and fsdp=): one replay of the pre-training
    StepLoop against eager steps from the same state. The WARMUP eager
    steps and the capture's step come first, so the compared step is a
    replay at a later row of the step table than the capture's, on
    another batch (a scalar or an input frozen into the graph at the
    capture would show). The parameters and the first moments after it,
    by relative L2 over all of them, must lie within twice the spread of
    two eager steps from the same state (+ 1e-6); the replays' metrics
    ["lr"] must equal lr_sched(step) in float32 exactly. Three more
    replays follow; with `strict` (phase 11), each whole step under
    torch.cuda.set_sync_debug_mode("error"), then one more under
    torch.profiler. Each step is timed between two synchronisations.
    -> dict(losses of the first WARMUP + 2 steps (their batches are
    fixed[0], fixed[1], ...), ms {warm-up, capture, replays} by step,
    card memory GB {state: allocated after init_state, eager: the peak of
    the warm-up, captured: that of the capture and the compared replay},
    and with `strict` the launch API calls and
    cudaGraphLaunch calls of the profiled replay)."""
    import copy

    import numpy as np
    import torch

    from instantsplat_tpu_torch.train_dust3r import trainer
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    model = copy.deepcopy(host_model).to(dev).requires_grad_(True)
    init, step, _ = trainer.make_dp_train_step(host_model.cfg,
                                               compute_dtype=None, **kw)
    lr_sched = trainer.cosine_warmup_schedule(
        kw["base_lr"], kw["min_lr"], kw["warmup_steps"], kw["total_steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init(model)
    losses, ms, peak = [], {"warm-up": [], "replays": []}, {}
    peak["state"] = torch.cuda.memory_allocated() / 1e9

    def timed(batch, into=None):
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        if into is not None:
            into.append((time.perf_counter() - t) * 1e3)
        return met

    for i in range(WARMUP):
        losses.append(float(timed(fixed[i % len(fixed)],
                                  ms["warm-up"])["loss"]))
    peak["eager"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    capture = []
    losses.append(float(timed(fixed[WARMUP % len(fixed)], capture)["loss"]))
    ms["capture"] = capture[0]
    batch = fixed[(WARMUP + 1) % len(fixed)]

    def snapshot(groups=("params", "m")):
        return {g: {k: t.detach().clone() for k, t in state[g].items()}
                for g in groups}

    s0, at = snapshot(("params", "m", "v")), state["step"]

    def restore():
        with torch.no_grad():
            for g, ts in s0.items():
                for k, t in state[g].items():
                    t.copy_(ts[k])
        state["step"] = at

    def rel(a, b):  # relative L2 over every tensor of the group
        ks = list(b)
        num = torch.stack([torch.linalg.vector_norm(
            (a[k].detach() - b[k]).double()) for k in ks]).norm()
        den = torch.stack([torch.linalg.vector_norm(b[k].double())
                           for k in ks]).norm()
        return float(num / den.clamp(min=1e-300))

    before = StepLoop.replays
    met = timed(batch)
    peak["captured"] = torch.cuda.max_memory_allocated() / 1e9
    losses.append(float(met["loss"]))
    lrs = [(state["step"], float(met["lr"]))]
    one = snapshot()
    with eager_loops():
        restore()
        state, _ = step(state, batch)
        eager = snapshot()
        restore()
        state, _ = step(state, batch)
        spread = {g: rel(state[g], eager[g]) for g in ("params", "m")}
    diff = {g: rel(one[g], eager[g]) for g in ("params", "m")}
    del s0, one, eager
    mets = []
    for i in range(3):  # replays at later rows
        if strict:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            t = time.perf_counter()
            state, met = step(state, fixed[i % len(fixed)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms["replays"].append((time.perf_counter() - t) * 1e3)
        mets.append((state["step"], met))
    lrs += [(s, float(met["lr"])) for s, met in mets]

    def more():
        nonlocal state
        state, _ = step(state, fixed[0])

    prof = api_profile(more, 1) if strict else None
    replays = StepLoop.replays - before
    del state, step, init, model
    torch.cuda.empty_cache()
    log(f"{tag} one step [{smi}]: the replay of step "
        f"{at + 1} against eager steps from the same state, relative L2: "
        f"parameters {diff['params']:.3e} (eager spread "
        f"{spread['params']:.3e}), first moments {diff['m']:.3e} (eager "
        f"spread {spread['m']:.3e}); replays' lr "
        + ", ".join(f"step {s}: {lr:.9g}" for s, lr in lrs))
    if replays != 4 + strict:
        fail(f"{tag}: {replays} replays, expected {4 + strict}")
    for g, label in (("params", "parameters"), ("m", "first moments")):
        if not diff[g] <= 2 * spread[g] + 1e-6:
            fail(f"{tag}: a replayed step's {label} differ "
                 f"from an eager step's by {diff[g]:.3e} relative L2 (eager "
                 f"spread {spread[g]:.3e})")
    for s, lr in lrs:
        if lr != float(np.float32(lr_sched(s))):
            fail(f"{tag}: the replay of step {s} used lr "
                 f"{lr!r}, lr_sched gives {float(np.float32(lr_sched(s)))!r}")
    out = dict(losses=losses, ms=ms, peak=peak)
    if prof is not None:
        out.update(launch_calls=launch_calls(prof["api"]),
                   graph_launches=prof["api"].get("cudaGraphLaunch", 0))
    return out


def graphs_pretrain(host_model, tmp: Path, dev, smi):
    """Phase 13 (h): the full-width bf16 pre-training step (phase 10's
    shape: 2 x accum 2 pairs at 512x384, mast3r_finetune) captured
    against eager from the same weights and batches: WARMUP eager steps,
    then P13_PRETRAIN_CAPTURED captured steps (replays) and
    P13_PRETRAIN_EAGER eager ones, each synchronised;
    P13_PRETRAIN_PROFILED more of each under torch.profiler; the two loss
    curves over their common steps."""
    import copy
    import itertools
    import statistics

    import numpy as np
    import torch

    from instantsplat_tpu_torch.train_dust3r import losses, trainer
    from instantsplat_tpu_torch.train_dust3r.datasets import (
        PosedMultiViewDataset)
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    ds = PosedMultiViewDataset(tmp / "pretrain",
                               resolution=[(PRETRAIN_W, PRETRAIN_H)],
                               n_corres=PRETRAIN_CORRES,
                               transform="color_jitter")
    loader = ds.batches(PRETRAIN_BATCH, seed=11, n_epochs=PRETRAIN_EPOCHS)
    fixed = [trainer.stack_microbatches(list(
        itertools.islice(loader, PRETRAIN_ACCUM))) for _ in range(5)]
    kw = dict(PRETRAIN_HYPER, loss_fn=losses.mast3r_finetune_loss,
              accum_iter=PRETRAIN_ACCUM, total_steps=PRETRAIN_STEPS)
    pretrain_one_step(host_model, fixed, kw, dev, smi)
    model = copy.deepcopy(host_model).to(dev).requires_grad_(True)
    start = [p.detach().clone() for p in model.parameters()]
    curves, ms, profs, peak = {}, {}, {}, {}
    counts = dict(captured=P13_PRETRAIN_CAPTURED, eager=P13_PRETRAIN_EAGER)
    for mode, n in counts.items():
        with torch.no_grad():
            for p, p0 in zip(model.parameters(), start):
                p.copy_(p0)
        ctx = eager_loops() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            init, step, _ = trainer.make_dp_train_step(
                host_model.cfg, compute_dtype=torch.bfloat16, **kw)
            state = init(model)
            loss, times = [], []
            before = StepLoop.replays
            for i in range(WARMUP + n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, met = step(state, fixed[i % len(fixed)])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                loss.append(float(met["loss"]))
            replays = StepLoop.replays - before

            def more():
                nonlocal state
                for j in range(P13_PRETRAIN_PROFILED):
                    state, _ = step(state, fixed[j % len(fixed)])

            prof = api_profile(more, P13_PRETRAIN_PROFILED)
            peak[mode] = torch.cuda.max_memory_allocated() / 1e9
            want = n if mode == "captured" else 0
            if replays != want:
                fail(f"phase 13 pretrain {mode}: {replays} replays, "
                     f"expected {want}")
            del state, step, init
        curves[mode] = loss
        ms[mode] = statistics.median(times[WARMUP + 1:] or times[WARMUP:])
        profs[mode] = dict(prof, k=P13_PRETRAIN_PROFILED)
        log(f"phase 13 pretrain {mode} [{smi}]: step ms "
            + ", ".join(f"{v:.1f}" for v in times) + "; losses "
            + ", ".join(f"{v:.6g}" for v in loss))
    common = min(len(c) for c in curves.values())
    rel = [abs(a - b) / abs(b) for a, b in zip(curves["captured"][:common],
                                                curves["eager"][:common])]
    if not np.isfinite(curves["captured"]).all():
        fail("phase 13 pretrain: a non-finite captured loss")
    loop_line(f"pretrain bf16 step ({PRETRAIN_BATCH} x accum "
              f"{PRETRAIN_ACCUM} pairs at {PRETRAIN_W}x{PRETRAIN_H}; median "
              f"of the last {P13_PRETRAIN_CAPTURED - 1} captured and "
              f"{P13_PRETRAIN_EAGER - 1} eager steps)", smi, "step", ms,
              profs, peak, max(rel), LOSS_RTOL,
              f"loss curves' max relative difference over {common} steps "
              f"(over steps 1-{WARMUP}, eager in both runs: "
              f"{max(rel[:WARMUP]):.3e})")
    del model, start
    torch.cuda.empty_cache()


def mesh_rank(tmp: Path, device: str = "cuda"):
    """Phase 13 (i), in a child process started by `stage_graphs`: a
    one-rank NCCL group; train_joint(mesh=) on phase 4's scene and align
    (mesh=) on phase 7's oracle pairs, captured (their collectives in the
    graphs) against eager (StepLoops as Python loops); the captured
    train_joint with TrainerConfig.profile_dir (block 1 traced). Writes
    the lines' numbers, the trace's summary (`read_trace`) and the
    kernels' launch counts to <tmp>/phase13.json."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from instantsplat_tpu_torch.init.aligner import GlobalAligner
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.parallel import initialize_runtime, make_mesh
    from instantsplat_tpu_torch.parallel.runtime import STORE_ENV
    from instantsplat_tpu_torch.pipelines.trainer import (TrainerConfig,
                                                          train_joint)
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_runtime(device,
                       init_method=f"file://{os.environ[STORE_ENV]}",
                       world_size=1, rank=0)
    mesh = make_mesh(1)
    dev = torch.device(device)
    kernels = kernel_table()
    for k in kernels.values():
        k.launches = 0
    scene = tmp / "scene"
    opt_cfg = OptimizationConfig(pp_optimizer=True, optim_pose=True)
    blocks = P13_TRAIN_ITERS // P13_LOG_EVERY
    preds = oracle_pointmap_fn(TRAIN_FRAMES, 0.9 * W)(
        None, make_pair_indices(3, "complete", symmetrize=True))
    curves, ms, profs, peak, aligned = {}, {}, {}, {}, {}
    p0, cams = initial_params(scene, dev)

    def fresh():
        return p0.replace(**{f: getattr(p0, f).clone()
                             for f in PARAM_FIELDS})

    for mode in ("captured", "eager"):
        ctx = eager_loops() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            # train_joint: timed between the ends of blocks 2 and `blocks`
            params = fresh()
            torch.cuda.reset_peak_memory_stats()
            before = StepLoop.replays
            # the captured run traces block 1 (profile_dir), which ends
            # before the timed blocks begin
            traced = str(tmp / "trace") if mode == "captured" else None
            _, _, hist = train_joint(
                params, cams, opt_cfg=opt_cfg, mesh=mesh,
                trainer_cfg=TrainerConfig(iterations=P13_TRAIN_ITERS,
                                          backend="pallas",
                                          log_every=P13_LOG_EVERY,
                                          profile_dir=traced))
            replays = StepLoop.replays - before
            peak[f"train {mode}"] = torch.cuda.max_memory_allocated() / 1e9
            want = P13_TRAIN_ITERS - WARMUP if mode == "captured" else 0
            if replays != want:
                fail(f"phase 13 mesh train_joint {mode}: {replays} "
                     f"replays, expected {want}")
            curves[mode] = [m["loss"] for _, m in hist]
            el = [m["elapsed_s"] for _, m in hist]
            ms[f"train {mode}"] = (el[-1] - el[1]) * 1e3 / (
                (blocks - 2) * P13_LOG_EVERY)
            params = fresh()
            n = WARMUP + 1 + 2 * P13_PROFILED  # one block, profiled inside
            with loop_profiles(P13_PROFILED) as got:
                train_joint(params, cams, opt_cfg=opt_cfg, mesh=mesh,
                            trainer_cfg=TrainerConfig(
                                iterations=n, backend="pallas",
                                log_every=n))
            profs[f"train {mode}"] = dict(got["make_train_scan"][0],
                                          k=P13_PROFILED)
            del params
            # align: (the P13_ALIGN_ITERS run) - (the 0-iteration run)
            secs = {}
            for n in (0, P13_ALIGN_ITERS):
                al = GlobalAligner(preds, device=dev)
                al.init_mst(focal_avg=True)
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                before = StepLoop.replays
                t0 = time.perf_counter()
                loss = al.align(niter=n, mesh=mesh)
                secs[n] = time.perf_counter() - t0
                if n and mode == "captured" and \
                        StepLoop.replays - before != n - WARMUP:
                    fail(f"phase 13 mesh align: {StepLoop.replays - before}"
                         f" replays for {n} iterations")
            peak[f"align {mode}"] = torch.cuda.max_memory_allocated() / 1e9
            aligned[mode] = (loss, al.get_im_poses().tolist())
            ms[f"align {mode}"] = (secs[P13_ALIGN_ITERS] - secs[0]) * 1e3 / \
                P13_ALIGN_ITERS
            al = GlobalAligner(preds, device=dev)
            al.init_mst(focal_avg=True)
            with loop_profiles(P13_PROFILED) as got:
                al.align(niter=WARMUP + 1 + P13_PROFILED + 1, mesh=mesh)
            profs[f"align {mode}"] = dict(got["align"][0], k=P13_PROFILED)
    (tmp / "phase13.json").write_text(json.dumps(dict(
        curves=curves, ms=ms, profs=profs, peak=peak,
        aligned=aligned, trace=read_trace(tmp / "trace", P13_LOG_EVERY),
        launches={name: k.launches for name, k in kernels.items()})))
    torch.distributed.destroy_process_group()


def graphs_mesh(tmp: Path, smi):
    """Phase 13 (i): `mesh_rank` in a child process; its lines checked
    and printed here. -> the child's kernel launches."""
    import numpy as np

    from instantsplat_tpu_torch.parallel import launch

    t0 = time.time()
    try:
        launch.spawn("chip_smoke", ["--phase13-rank", str(tmp)], 1,
                     timeout=P11_LIMIT_S, cwd=str(REPO))
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 13 (i): {e}")
    got = json.loads((tmp / "phase13.json").read_text())
    check_trace(got["trace"], P13_LOG_EVERY, smi)
    c, e = got["curves"]["captured"], got["curves"]["eager"]
    diff = max(abs(a - b) / abs(b) for a, b in zip(c, e))
    loop_line(f"train_joint over a one-rank NCCL mesh ({P13_TRAIN_ITERS} "
              f"iterations in blocks of {P13_LOG_EVERY}, pallas)", smi,
              "iteration", {m: got["ms"][f"train {m}"] for m in ("captured",
                                                                "eager")},
              {m: got["profs"][f"train {m}"] for m in ("captured", "eager")},
              {m: got["peak"][f"train {m}"] for m in ("captured", "eager")},
              diff, LOSS_RTOL, "loss curves' max relative difference")
    (lc, pc), (le, pe) = got["aligned"]["captured"], got["aligned"]["eager"]
    d_pose = float(np.abs(np.asarray(pc) - np.asarray(pe)).max())
    loop_line(f"align over a one-rank NCCL mesh ({P13_ALIGN_ITERS} "
              "iterations, 6 oracle pairs)", smi, "iteration",
              {m: got["ms"][f"align {m}"] for m in ("captured", "eager")},
              {m: got["profs"][f"align {m}"] for m in ("captured", "eager")},
              {m: got["peak"][f"align {m}"] for m in ("captured", "eager")},
              d_pose, ALIGN_POSE_ATOL,
              f"final loss relative {abs(lc - le) / le:.3e}, poses max |d|")
    log(f"phase 13 (i) [{smi}]: {time.time() - t0:.1f} s in the child "
        f"process; its launches {got['launches']}")
    return got["launches"]


def to_cuda_rows(opt, iterations, first_step: int, dev):
    """opt.step_scalars(iterations, first_step) on the card."""
    from instantsplat_tpu_torch.utils.cuda_graphs import to_device

    return to_device(opt.step_scalars(list(iterations), first_step), dev)


def main():
    import numpy as np
    import torch

    if sys.argv[1:2] == ["--phase11-rank"]:  # phase 11's child process
        parallel_rank(Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--phase13-rank"]:  # phase 13's child process
        mesh_rank(Path(sys.argv[2]))
        return
    # ---- phase 1: card ---------------------------------------------------
    t_start = time.time()
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
    from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP

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
        params, history, launches, secs, _, dem, replays = train_run(
            scene, Path(tmp) / "dense", "pallas", 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steady = {"dense": check_run("dense (--backend pallas)", history,
                                     launches, secs, dem, 1)}
        # phase 13's comparison: each backend's captured run
        captured = {"dense": (history, steady["dense"], replays)}
        log(f"train dense: peak memory {peak_gb:.2f} GB; {replays} CUDA "
            f"graph replays (the first {WARMUP} iterations eager)")
        if replays != TRAIN_ITERS - WARMUP:
            fail(f"dense run: {replays} graph replays, expected "
                 f"{TRAIN_ITERS - WARMUP}")
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

        _, history, launches, secs, _, dem, _ = train_run(
            scene, Path(tmp) / "dense2", "pallas", 1)
        check_run("dense, second run", history, launches, secs, dem, 1,
                  dense_losses)

        # auto: the probe times 10-iteration blocks, as with log_every 100
        _, history, launches, secs, auto_lines, dem, replays = train_run(
            scene, Path(tmp) / "auto", "auto", 10)
        for ln in auto_lines:
            log(f"train auto: trainer said: {ln.strip()}")
        steady["auto"] = check_run("auto", history, launches, secs, dem, 10,
                                   dense_losses)
        captured["auto"] = (history, steady["auto"], replays)
        log(f"train auto: {replays} CUDA graph replays")
        if not TRAIN_ITERS - 4 * WARMUP <= replays < TRAIN_ITERS:
            fail(f"auto run: {replays} graph replays")
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
            _, history, launches, secs, _, dem, replays = train_run(
                scene, Path(tmp) / kind, backend, 1)
            steady[kind] = check_run(f"{kind} ({backend})", history,
                                     launches, secs, dem, 1, dense_losses)
            captured[kind] = (history, steady[kind], replays)
            if dem:
                fail(f"{kind} run: the overflow guard demoted {backend}")
            if replays != TRAIN_ITERS - WARMUP:
                fail(f"{kind} run: {replays} graph replays, expected "
                     f"{TRAIN_ITERS - WARMUP}")
            if any(launches[k] != TRAIN_ITERS for k in ("KR", kf, kb)):
                fail(f"{kind} run: KR/{kf}/{kb} launched {launches['KR']}/"
                     f"{launches[kf]}/{launches[kb]} times, expected "
                     f"{TRAIN_ITERS}")
            path_launches.update({kf: launches[kf], kb: launches[kb]})
        log("steady ms/iter by backend: " + ", ".join(
            f"{k} {v:.2f}" for k, v in steady.items()))

        log(f"{time.time() - t_start:.0f} s since the start")
        # ---- phase 5: the training shape, trained scene ------------------
        rows = training_shape(params, cam, dev, path_launches)

        log(f"{time.time() - t_start:.0f} s since the start")
        # ---- phase 6: stages 3 and 5 on the dense run's model ------------
        stages_3_and_5(scene, Path(tmp) / "dense", dev, smi)

        log(f"{time.time() - t_start:.0f} s since the start")
        # ---- phase 7: stage 1 on copies of the dataset -------------------
        oracle, mast3r = stage_1(scene, Path(tmp), dev, smi)

        log(f"{time.time() - t_start:.0f} s since the start")
        # ---- phase 8: the rest of the toolchain on the oracle scene ------
        phase8 = stage_tools(oracle, Path(tmp), dev, smi)

        # ---- phase 9: the sparse-alignment family ------------------------
        log(f"{time.time() - t_start:.0f} s since the start")
        phase9 = stage_sparse(params, cams, mast3r[:3], Path(tmp), dev, smi)
        host_model = mast3r[3]
        del mast3r, params

        # ---- phase 10: MASt3R pre-training at full width -----------------
        log(f"{time.time() - t_start:.0f} s since the start")
        phase10 = stage_pretrain(host_model, Path(tmp), dev, smi)

        # ---- phase 11: the multi-device layer ----------------------------
        log(f"{time.time() - t_start:.0f} s since the start")
        phase11 = stage_parallel(scene, Path(tmp), dev, smi)

        # ---- phase 12: the structured entry points -----------------------
        log(f"{time.time() - t_start:.0f} s since the start")
        phase12 = stage_structured(scene, Path(tmp), dev, smi)

        # ---- phase 13: the device-resident loops -------------------------
        log(f"{time.time() - t_start:.0f} s since the start")
        phase13 = stage_graphs(scene, Path(tmp), captured, {
            kind: backend for kind, (backend, _) in explicit.items()},
            host_model, dev, smi)
        del host_model
        for row in rows:
            row["launches_phase8"] = phase8[row["name"].split()[0]]
            row["launches_phase9"] = phase9[row["name"].split()[0]]
            row["launches_phase10"] = phase10[row["name"].split()[0]]
            row["launches_phase11"] = phase11[row["name"].split()[0]]
            row["launches_phase12"] = phase12[row["name"].split()[0]]
            row["launches_phase13"] = phase13[row["name"].split()[0]]
        log(f"{time.time() - t_start:.0f} s since the start")

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
