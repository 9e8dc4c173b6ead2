"""Joint Gaussian + camera-pose optimisation loop (port of
instantsplat_tpu/pipelines/trainer.py::train_joint).

Each iteration renders one training view with its learnable pose, takes
0.8*L1 + 0.2*(1-SSIM) against the ground truth, and applies the grouped
(optionally per-point) Adam step, pose group included. Kept from the JAX
loop: views drawn without replacement per epoch from
np.random.RandomState(seed).permutation (so both packages visit the views
in the same order), the SH ramp every `sh_up_interval` iterations, the
black or white background, the `log_every` history, resume from an
(opt_state, first_iter) pair, mixed-aspect scenes (each view rendered at
its own shape), and backend="auto": the timed probe of the dense kernels
against a capacity backend sized for the scene, and its periodic re-probe
(see train_joint).

The iterations run in blocks, as JAX's `make_train_scan` runs them
(`TrainerConfig.scan`, the default): on a card each block is replays of
one captured CUDA graph of the step (utils/cuda_graphs.StepLoop), which
gathers its view by a device index and reads its learning rates and bias
corrections from a device table, so the host makes one graph launch per
iteration and reads the metrics at the block's end; on the CPU the same
step runs in a Python loop. With a mesh the step's collectives (the
sharded render's gathers, the gradient all-reduce) are captured with it.
The eager loop (`train_step` per iteration) runs where JAX's does: with a
viewer, on mixed-shape scenes, with scan=False. Left out as a TPU
workaround: the dispatch governor that bounded each scanned block under
the TPU runtime's execution deadline (JAX's dispatch_budget_s,
_fit_block). With a mesh (`TrainerConfig.n_devices`, or `mesh=`), every
render is sharded over the ranks (parallel/sharding.py); rank 0 draws the
view order and broadcasts it (a block's view table, on the device), and
`auto` resolves to the dense kernels, as in JAX. With a `viewer`
(render/network_gui.NetworkGUI), every iteration first answers at most
one pending viewer request (_serve_viewer). With
`TrainerConfig.profile_dir`, block 1 (replays, on a card) runs under a
torch.profiler trace written there (utils/profiling.py), as JAX traces
its second block.

What the loop records (utils/profiling.py): the spans `train.block` (each
block), `train.probe` (the auto probe's and a re-probe's sizing and
blocks; `train.size_caps` inside `_binned_candidate`), `train.upload`
(a block's view and Adam tables), `train.marks` (their read, tracing
on), `train.log` (the metrics' read and progress_cb at a log); the
counters `train.iterations.<family>` (by backend family, `eager` for the
eager loop), `train.reprobes`, `train.resizes`, `train.switches`. With
tracing on, each make_train_scan block marks its start and each step its
STEP_MARKS on the device, and the block's end adds its PHASES to the
phase table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from instantsplat_tpu_torch.models.camera import (Camera, gather_camera,
                                                 stack_cameras)
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import (
    AdamState,
    GaussianOptimizer,
    OptimizationConfig,
)
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled
from instantsplat_tpu_torch.ops.losses import photometric_loss, psnr
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import (
    binned_view_requirements,
    render,
    tiled_view_requirements,
)
from instantsplat_tpu_torch.utils import profiling
from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop, to_device

_log = logging.getLogger(__name__)

# the device marks of a traced make_train_scan step, in stream order: its
# start; the front end's columns (ops/frontend.py); the render (depth sort,
# lists, compositor, composite_out); photometric_loss; the gradient
# reaching rgb (the loss backward done); the gradient reaching the packed
# splats (the raster backward done; no such hook on the sharded render);
# autograd.grad's return (front end and pose backward done); PSNR; Adam
STEP_MARKS = ("start", "frontend", "render", "loss", "loss_bwd",
              "raster_bwd", "grad", "metrics", "adam")
# the marks table's columns: the block's own start (row 0 only, launched
# before its tables are uploaded), then the step's
MARKS = ("block",) + STEP_MARKS
# the phases that the marks cut a block into, each the (from, to) mark
# intervals it sums; with replay_gap's intervals from one step's last mark
# to the next step's first (profiling.add_step_marks) they cover the block
# once. A missing mark joins its interval to the next: without the packed
# hook `raster` holds the front end's backward
PHASES = {"frontend": (("start", "frontend"), ("raster_bwd", "grad")),
          "raster": (("frontend", "render"), ("loss_bwd", "raster_bwd")),
          "loss": (("render", "loss"), ("loss", "loss_bwd"),
                   ("grad", "metrics")),
          "adam": (("metrics", "adam"),),
          "replay_gap": (("block", "start"),)}


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    iterations: int = 1000
    white_background: bool = False
    backend: str = "oracle"
    chunk: int = 256
    sh_up_interval: int = 1000  # reference train.py:148-149
    seed: int = 0
    log_every: int = 100
    # run log_every iterations as one block (make_train_scan): on a card,
    # replays of one captured CUDA graph, the metrics read at the block's
    # end. Off with a live viewer (per-iteration polling) and on
    # mixed-shape scenes, which step eagerly
    scan: bool = True
    # when set, the second block (block 0 holds the warm-up and the
    # capture, block 1 replays) runs under a torch.profiler trace written
    # to this directory (utils/profiling.py)
    profile_dir: Optional[str] = None
    # renders sharded over an n_devices 1-D mesh (parallel/sharding.py):
    # 0/None/1 = one device; -1 = every rank of the group. shard_axis:
    # 'pixels' (row blocks per rank) or 'gaussians' (depth slices)
    n_devices: Optional[int] = None
    shard_axis: str = "pixels"


def _render_rgb(p, cam, pose, bg, active_sh, chunk, backend, mesh,
                shard_axis):
    """One view's RGB from the one-device driver, or sharded over `mesh`
    (row blocks or depth slices; the gradients reaching p and pose are the
    whole image's on every rank)."""
    if mesh is None:
        return render(p, cam, pose=pose, bg=bg, active_sh_degree=active_sh,
                      chunk=chunk, backend=backend).render
    from instantsplat_tpu_torch.parallel import sharding

    if shard_axis == "gaussians":
        return sharding.gaussian_sharded_render(
            p, cam, mesh, pose=pose, bg=bg, active_sh_degree=active_sh)[0]
    return sharding.sharded_render(
        p, cam, mesh, pose=pose, bg=bg, active_sh_degree=active_sh,
        chunk=chunk, backend=backend)[0]


def _step_metrics(params: GaussianModel, cam: Camera, pose, bg,
                  active_sh: int, lambda_dssim: float, backend: str,
                  chunk: int, mesh, shard_axis: str):
    """render -> loss -> gradients of every parameter field. -> (grads by
    field, metrics as 0-dim tensors)."""
    tensors = params.tensors()
    for t in tensors:
        t.requires_grad_(True)
    rgb = _render_rgb(params, cam, pose(), bg, active_sh, chunk, backend,
                      mesh, shard_axis)
    profiling.mark("render")
    profiling.mark_grad(rgb, "loss_bwd")
    loss, aux = photometric_loss(rgb, cam.image, lambda_dssim)
    profiling.mark("loss")
    grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    profiling.mark("grad")
    for t in tensors:
        t.requires_grad_(False)
    grads = {name: (torch.zeros_like(t) if g is None else g)
             for name, t, g in zip(PARAM_FIELDS, tensors, grads)}
    with torch.no_grad():
        aux["psnr"] = psnr(rgb, cam.image)
    profiling.mark("metrics")
    return grads, dict(loss=loss.detach(), l1=aux["l1"].detach(),
                       ssim=aux["ssim"].detach(), psnr=aux["psnr"])


def train_step(params: GaussianModel, cam: Camera, optimizer, opt_state,
               iteration: int, active_sh: int, bg, lambda_dssim: float,
               backend: str, chunk: int, mesh=None,
               shard_axis: str = "pixels", *, scalars=None) -> dict:
    """render -> loss -> backward -> Adam, in place, eagerly. Returns the
    metrics as 0-dim tensors (reading them synchronises with the device).
    scalars: this step's row of optimizer.step_scalars on the device
    (made here when None)."""
    grads, metrics = _step_metrics(
        params, cam, lambda: params.get_pose(cam.uid), bg, active_sh,
        lambda_dssim, backend, chunk, mesh, shard_axis)
    optimizer.step(params, grads, opt_state, iteration, scalars=scalars)
    return metrics


def make_train_scan(optimizer: GaussianOptimizer, cameras: Camera, bg,
                    lambda_dssim: float, backend: str, chunk: int, mesh=None,
                    shard_axis: str = "pixels", *, pool=None):
    """A k-iteration training block (JAX's make_train_scan):
    train_block(params, opt_state, view_ids [k], iterations [k],
    active_sh) -> (params, opt_state, metrics of the block's last
    iteration), params and moments updated in place.

    cameras: `stack_cameras` of views of one shape. Each step gathers its
    view by a device step counter from the block's view ids, and its
    Adam factors from the block's `optimizer.step_scalars` table; both are
    copied to the device once per block, so the step holds no host value.
    On a card the first iterations run eagerly on a side stream, one step
    is captured into a CUDA graph, and every later iteration is a replay
    (utils/cuda_graphs.StepLoop). A graph is kept per (active_sh, the
    demoted capacity signatures for a capacity backend, the tensors'
    storage, whether tracing is on), all in one memory pool (`pool`, or
    one of this block function's own). On the CPU the same step runs in a
    Python loop. With tracing on (utils/profiling.enable) the block marks
    its start and each step its STEP_MARKS into a table beside the view
    ids, and the block's end reads the block's rows (one copy to the host)
    into the phase table under ("make_train_scan", the backend's family);
    off, nothing is marked and no hook registered.
    With a mesh the graph holds the sharded render's collectives (NCCL),
    and the block's view ids are rank 0's, broadcast on the device once a
    block.
    `active_sh` is static per block: callers split blocks at SH-ramp
    boundaries, as train_joint does."""
    dev = bg.device
    if dev.type == "cuda" and pool is None:
        pool = torch.cuda.graph_pool_handle()
    groups = () if mesh is None else [mesh.get_group(name) for name in
                                      mesh.mesh_dim_names]
    blocks: dict = {}
    family = backend.split(":")[0]

    def statics(params, opt_state, k: int, active_sh: int):
        """(the loop, its tensors) of this block's key, with room for k
        iterations (more room means a new capture)."""
        key = (active_sh, _is_capacity_backend(backend)
               and frozenset(driver._guard.demoted),
               tuple(t.data_ptr() for t in params.tensors()
                     + list(opt_state.m.values())
                     + list(opt_state.v.values())),
               profiling.enabled())
        if key not in blocks:
            blocks.clear()  # a stale key's graph is never replayed again
            # the step's tensors: `step` holds them, never the loop (no
            # reference cycle keeps a dead graph for the cyclic collector)
            bufs = SimpleNamespace(cap=0, counter=torch.zeros(
                1, dtype=torch.int64, device=dev), marks=None,
                traced=key[-1])

            def step():
                i = bufs.counter
                with profiling.marking(bufs.marks, i):
                    profiling.mark("start")
                    cam = gather_camera(cameras,
                                        bufs.views.index_select(0, i))
                    grads, metrics = _step_metrics(
                        params, cam,
                        lambda: params.cam_poses.index_select(0, cam.uid)[0],
                        bg, active_sh, lambda_dssim, backend, chunk, mesh,
                        shard_axis)
                    optimizer.apply_step(params, grads, opt_state,
                                         bufs.table.index_select(0, i)[0])
                    profiling.mark("adam")
                i.add_(1)
                return metrics

            blocks[key] = (StepLoop(step, dev, "make_train_scan", pool,
                                    groups=groups), bufs)
        loop, bufs = blocks[key]
        if bufs.cap < k:  # room for 1024 iterations (32 KB) at least
            bufs.cap = cap = 1 << max(k - 1, 1023).bit_length()
            bufs.views = torch.zeros(cap, dtype=torch.int64, device=dev)
            bufs.table = torch.zeros((cap, len(PARAM_FIELDS) + 1),
                                     device=dev)
            if bufs.traced:
                bufs.marks = profiling.StepMarks(MARKS, cap, dev)
            loop.reset_graph()
        return loop, bufs

    def train_block(params, opt_state, view_ids, iterations, active_sh: int):
        k = len(iterations)
        loop, bufs = statics(params, opt_state, k, active_sh)
        with profiling.annotate("train.upload"):
            bufs.counter.zero_()
            with profiling.marking(bufs.marks, bufs.counter):
                profiling.mark("block")
            bufs.table[:k].copy_(to_device(optimizer.step_scalars(
                iterations, opt_state.step + 1), dev))
            bufs.views[:k].copy_(to_device(np.asarray(view_ids), dev,
                                           torch.int64))
            if mesh is not None:  # rank 0's view order on every rank
                import torch.distributed as dist

                dist.broadcast(bufs.views[:k],
                               dist.get_global_rank(groups[0], 0),
                               group=groups[0])
        metrics = loop.run(k)
        opt_state.step += k
        if bufs.marks is not None:
            with profiling.annotate("train.marks"):
                profiling.add_step_marks(
                    "make_train_scan", family,
                    bufs.marks.times[:k].cpu().numpy(), MARKS, PHASES)
        return params, opt_state, {n: v.clone() for n, v in metrics.items()}

    return train_block


# backend='auto': refuse binned/tiled above these capacities (list memory
# and build cost scale with cap_factor * N and with the candidate level
# product; extreme requirements mean the scene is dense-kernel territory)
_MAX_BINNED_CAP_FACTOR = 16
_MAX_BINNED_D_LEVELS = 128
_MAX_TILED_LEVEL_PRODUCT = 64  # dy * dx (the candidate sort is O(N*dy*dx))

# Periodic backend re-probe cadence (iterations); module-level so tests can
# shrink it
_REPROBE_EVERY = 250
# A re-probe switches only when the other backend takes below this share
# of the current one's time per iteration
_SWITCH_SHARE = 0.87
# The probe's clock; module-level so tests can substitute a fake one
_clock = time.perf_counter


def _tiled_candidate(params, camera, pose) -> Optional[str]:
    """'pallas-tiled:CF:DY:DX' sized for the CURRENT scene seen from
    `pose`, or None when out of range (huge splats blow the level product;
    huge images blow the int32 tile*splat key space)."""
    n = int(params.xyz.shape[0])
    if rasterize_pallas_tiled.geometry(camera.height, camera.width).n_seg \
            * (n + 1) >= 2**31:
        return None
    cf, dy, dx = tiled_view_requirements(params, pose, camera)
    if cf > _MAX_BINNED_CAP_FACTOR or dy * dx > _MAX_TILED_LEVEL_PRODUCT:
        return None
    return f"pallas-tiled:{cf}:{dy}:{dx}"


def _binned_candidate(params, camera, pose=None) -> Optional[str]:
    """The capacity backend string for backend='auto' whose capacities hold
    every splat of the CURRENT scene state seen from `pose` (default: the
    learnable pose of view 0), or None when the needed capacity is
    unreasonable. Prefers the 2-D tiled backend (tighter culling); falls
    back to the 1-D binned one when the tile levels are out of range
    (giant splats). A failed probe logs a warning and returns None (auto
    then stays dense)."""
    if pose is None:
        pose = params.get_pose(0)
    try:
        with profiling.annotate("train.size_caps"):
            cand = _tiled_candidate(params, camera, pose)
            if cand is not None:
                return cand
            cf, dl = binned_view_requirements(params, pose, camera)
        if cf > _MAX_BINNED_CAP_FACTOR or dl > _MAX_BINNED_D_LEVELS:
            return None
        return f"pallas-binned:{cf}:{dl}"
    except Exception as e:  # noqa: BLE001 - auto must never kill training,
        # but a swallowed probe failure forfeits the faster backend, so it
        # is made visible
        _log.warning("backend auto: binned sizing probe failed (%s: %s); "
                     "falling back to dense", type(e).__name__, e)
        return None


def _is_capacity_backend(name: Optional[str]) -> bool:
    return bool(name) and name.startswith(("pallas-binned", "pallas-tiled"))


def _binned_caps_grew(old: str, new: str) -> bool:
    """True when `new`'s capacities exceed `old`'s in any dimension (smaller
    fresh requirements are still drop-free under the larger capacities). A
    kind change (tiled <-> binned) always counts."""
    okind, *ocaps = old.split(":")
    nkind, *ncaps = new.split(":")
    if okind != nkind or len(ocaps) != len(ncaps) or not ocaps:
        return old != new
    return any(int(nc) > int(oc) for oc, nc in zip(ocaps, ncaps))


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_joint(
    params: GaussianModel,
    cameras: list[Camera],
    opt_cfg: OptimizationConfig = OptimizationConfig(),
    trainer_cfg: TrainerConfig = TrainerConfig(),
    spatial_lr_scale: float = 1.0,
    confidence_lr: Optional[np.ndarray] = None,
    progress_cb: Optional[Callable[[int, dict], None]] = None,
    opt_state: Optional[AdamState] = None,
    first_iter: int = 0,
    live_ref: Optional[list] = None,
    viewer=None,
    mesh=None,
):
    """Run the joint optimisation; `params` is updated in place.

    mesh: a 1-D DeviceMesh (parallel.make_mesh); built here from
    trainer_cfg.n_devices when that asks for more than one device. Every
    render is then sharded per trainer_cfg.shard_axis, every rank runs the
    same loop and ends with the same parameters.

    live_ref: a 1-element list set to the latest params before each
    progress_cb call (the validation sweep renders what it holds).
    viewer: a NetworkGUI whose pending request, if any, is answered with
    a render of the current params before each iteration's step.

    Returns (params, opt_state, history), history being a list of
    (iteration, metrics dict) at log_every cadence plus the final step.

    Iterations run in blocks that end at log boundaries and never cross an
    SH-ramp boundary, as the JAX loop's scan blocks do. With
    trainer_cfg.scan, no viewer and one image shape (JAX's condition),
    with or without a mesh, each block is one call of a make_train_scan
    block function of its backend (on a card: graph replays); otherwise
    train_step runs per iteration. Both read the same Adam table, so the
    two give the same bits on the CPU. With
    backend="auto" on a scene of one image shape, blocks of
    probe = min(10, log_every) iterations come first: blocks 0-1 run the
    dense kernels and blocks 2-3 the capacity candidate (_binned_candidate,
    sized on camera 0); the second block of each is timed and the faster
    backend is kept. Every _REPROBE_EVERY iterations the capacity side is
    re-sized against the live scene (or demoted when it no longer fits),
    one block is timed on each backend, and the loop switches when the
    other takes below _SWITCH_SHARE of the current one's time. The view
    order, iteration numbers and SH ramp are those of a fixed backend.
    Mixed-shape scenes resolve auto to the dense kernels.
    """
    dev = params.xyz.device
    bg = (torch.ones(3, device=dev) if trainer_cfg.white_background
          else torch.zeros(3, device=dev))
    if mesh is None and trainer_cfg.n_devices not in (None, 0, 1):
        from instantsplat_tpu_torch.parallel import make_mesh

        mesh = make_mesh(None if trainer_cfg.n_devices == -1
                         else trainer_cfg.n_devices)
    sharded = {}  # train_step's mesh arguments
    if mesh is not None:
        from instantsplat_tpu_torch.parallel import runtime

        sharded = dict(mesh=mesh, shard_axis=trainer_cfg.shard_axis)
        group = mesh.get_group()
        if runtime.is_main_process():
            print(f"[train] sharding renders over {mesh.mesh.numel()} "
                  f"devices (axis: {trainer_cfg.shard_axis})", flush=True)
    optimizer = GaussianOptimizer(opt_cfg, spatial_lr_scale=spatial_lr_scale,
                                  total_iterations=trainer_cfg.iterations)
    if opt_state is None:
        opt_state = optimizer.init(params, confidence_lr=confidence_lr)

    rng = np.random.RandomState(trainer_cfg.seed)
    queue: list[int] = []

    log_every = trainer_cfg.log_every
    mixed_shapes = len({(c.height, c.width) for c in cameras}) > 1
    use_scan = trainer_cfg.scan and viewer is None and not mixed_shapes

    def next_view() -> int:
        nonlocal queue
        if not queue:
            queue = list(rng.permutation(len(cameras)))
            if mesh is not None and not use_scan:  # rank 0's draw on every
                # rank; a block broadcasts its view table instead
                queue = runtime.broadcast_object(queue, group)
        return int(queue.pop())

    if use_scan:
        stacked = stack_cameras(cameras)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        block_fns: dict = {}  # backend name -> make_train_scan block

        def block_fn(name: str):
            """The block function of `name`; those of names no longer in
            play are dropped with their graphs."""
            for stale in set(block_fns) - {name, cur_name, alt_name}:
                del block_fns[stale]
            if name not in block_fns:
                block_fns[name] = make_train_scan(
                    optimizer, stacked, bg, opt_cfg.lambda_dssim, name,
                    trainer_cfg.chunk, mesh=mesh,
                    shard_axis=trainer_cfg.shard_axis, pool=pool)
            return block_fns[name]
    cur_name = trainer_cfg.backend
    alt_name: Optional[str] = None
    if cur_name == "auto":
        cur_name = "pallas"
        if not mixed_shapes and mesh is None:
            with profiling.annotate("train.probe"):
                alt_name = _binned_candidate(params, cameras[0])
    probe = max(1, min(10, log_every))
    # None while the first probe runs (blocks of `probe`), then log_every
    block_cap: Optional[int] = None if alt_name is not None else log_every
    per_iter_main = per_cur_probe = 0.0
    next_reprobe = first_iter + 1 + _REPROBE_EVERY
    reprobe_state = 0  # 0 idle, 1 timing current, 2 timing other

    history = []
    t0 = time.time()
    it = first_iter + 1
    block_idx = 0
    while it <= trainer_cfg.iterations:
        interval = trainer_cfg.sh_up_interval
        end = min(trainer_cfg.iterations, ((it - 1) // log_every + 1)
                  * log_every)
        if it // interval < params.max_sh_degree:
            end = min(end, (it // interval + 1) * interval - 1)
        end = min(end, it + (block_cap or probe) - 1)
        name = (alt_name if block_cap is None and block_idx in (2, 3)
                else cur_name)
        if (block_cap is not None and alt_name is not None
                and reprobe_state == 0 and it >= next_reprobe):
            # re-size the capacity side against the live scene before
            # timing: its capacities were sized when it was chosen
            binned_side = ("cur" if _is_capacity_backend(cur_name)
                           else "alt" if _is_capacity_backend(alt_name)
                           else None)
            start_timing = True
            if binned_side is not None:
                with profiling.annotate("train.probe"):
                    fresh = _binned_candidate(params, cameras[0])
                old = cur_name if binned_side == "cur" else alt_name
                if fresh is None:
                    if binned_side == "cur":
                        cur_name, alt_name = alt_name, cur_name
                        name = cur_name
                        profiling.count("train.switches")
                        print("[train] backend auto: demoting binned at "
                              f"iter {it} — required capacities now "
                              "unreasonable for this scene", flush=True)
                    start_timing = False  # skip this window; retry later
                elif _binned_caps_grew(old, fresh):
                    if binned_side == "cur":
                        cur_name = name = fresh
                    else:
                        alt_name = fresh
                    profiling.count("train.resizes")
                    print(f"[train] backend auto: binned capacities resized "
                          f"{old} -> {fresh} at iter {it}", flush=True)
            if start_timing:
                reprobe_state = 1
                profiling.count("train.reprobes")
            else:
                next_reprobe = it + _REPROBE_EVERY
        if reprobe_state == 2:
            name = alt_name
        timed = (block_cap is None and block_idx in (1, 3)) or reprobe_state
        active_sh = min(it // interval, params.max_sh_degree)
        profiling.count("train.iterations."
                        + (name.split(":")[0] if use_scan else "eager"),
                        end - it + 1)
        with profiling.profile_trace(trainer_cfg.profile_dir,
                                     enabled=block_idx == 1), \
                (profiling.annotate("train.probe")
                 if block_cap is None or reprobe_state
                 else contextlib.nullcontext()), \
                profiling.annotate("train.block"):
            # the clock is read inside the traced region: the trace's start,
            # stop and export (block 1 under profile_dir) stay out of the
            # auto probe's time
            if timed:
                _sync(dev)
            t_blk = _clock()
            if use_scan:
                views = [next_view() for _ in range(it, end + 1)]
                params, opt_state, metrics = block_fn(name)(
                    params, opt_state, views, list(range(it, end + 1)),
                    active_sh)
            else:
                table = to_device(optimizer.step_scalars(
                    range(it, end + 1), opt_state.step + 1), dev)
                for j, i in enumerate(range(it, end + 1)):
                    if viewer is not None:
                        _serve_viewer(viewer, params, name,
                                      trainer_cfg.chunk)
                    view = next_view()
                    metrics = train_step(params, cameras[view], optimizer,
                                         opt_state, i, active_sh, bg,
                                         opt_cfg.lambda_dssim, name,
                                         trainer_cfg.chunk, **sharded,
                                         scalars=table[j])
            if timed:
                _sync(dev)
            per_iter = (_clock() - t_blk) / (end - it + 1)
        if reprobe_state == 1:
            per_cur_probe = per_iter
            reprobe_state = 2
        elif reprobe_state == 2:
            if per_iter < _SWITCH_SHARE * per_cur_probe:
                cur_name, alt_name = alt_name, cur_name
                profiling.count("train.switches")
                print(f"[train] backend auto: switching at iter {it} — "
                      f"other backend {per_iter * 1e3:.0f} ms/iter beats "
                      f"current {per_cur_probe * 1e3:.0f}", flush=True)
            reprobe_state = 0
            next_reprobe = it + _REPROBE_EVERY
        if block_cap is None and block_idx == 1:
            per_iter_main = per_iter
        if block_cap is None and block_idx == 3:
            if per_iter < per_iter_main:
                cur_name, alt_name = alt_name, cur_name
                win, lose, t_win, t_lose = ("binned", "dense", per_iter,
                                            per_iter_main)
            else:
                win, lose, t_win, t_lose = ("dense", "binned", per_iter_main,
                                            per_iter)
            print(f"[train] backend auto: {win} ({t_win * 1e3:.0f} ms/iter) "
                  f"beats {lose} ({t_lose * 1e3:.0f} ms/iter)", flush=True)
            block_cap = log_every
        block_idx += 1
        if end % log_every == 0 or end == trainer_cfg.iterations:
            with profiling.annotate("train.log"):
                m = {k: float(v) for k, v in metrics.items()}
                m["elapsed_s"] = time.time() - t0
                history.append((end, m))
                if live_ref is not None:
                    live_ref[0] = params
                if progress_cb is not None:
                    progress_cb(end, m)
        it = end + 1
    return params, opt_state, history


def _serve_viewer(viewer, params: GaussianModel, backend: str, chunk: int):
    """Answer at most one pending viewer request with a render of the
    current params on `backend`, under no_grad. A viewer error drops the
    connection with a warning and never stops training."""
    try:
        req = viewer.poll()
        if req is None:
            return
        with torch.no_grad():
            out = render(params, req.camera(params.xyz.device),
                         scale_modifier=req.scaling_modifier, chunk=chunk,
                         backend=backend)
        viewer.send_image(out.render.cpu().numpy(), verify="training")
    except Exception as e:  # noqa: BLE001 - the viewer must never kill
        # training; the dropped connection is made visible
        _log.warning("viewer request failed (%s: %s); connection dropped",
                     type(e).__name__, e, exc_info=True)
        viewer.conn = None
