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
(_AutoProbe).

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
blocks; `train.size_caps` inside driver.capacity_candidate), `train.upload`
(a block's view and Adam tables), `train.marks` (their read, tracing
on), `train.log` (the metrics' read and progress_cb at a log); the
counters `train.iterations.<family>` (by backend family, `eager` for the
eager loop), `train.reprobes`, `train.resizes`, `train.switches`,
`adam.fused_steps` (a block's steps taken by ops/adam.py's kernels). With
tracing on, each make_train_scan block marks its start and each step its
STEP_MARKS on the device, and the block's end adds its PHASES to the
phase table and, from ops/adam.py's skip table zeroed at the block's
start, `adam.skipped.<field>`: the block's steps in which that group's
whole-tensor zero-gradient skip held.
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
from instantsplat_tpu_torch.ops import adam
from instantsplat_tpu_torch.ops.losses import photometric_loss, psnr
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import render
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
    one of this block function's own), beside the overflow flags its
    renders record (driver.recording_overflow). On the CPU the same step
    runs in a Python loop. With tracing on (utils/profiling.enable) the
    block marks its start and each step its STEP_MARKS into a table beside
    the view ids, and the block's end reads the block's rows (one copy to
    the host) into the phase table under ("make_train_scan", the backend's
    family); off, nothing is marked and no hook registered.
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
    family = driver.family(backend)

    def statics(params, opt_state, k: int, active_sh: int):
        """(the loop, its tensors) of this block's key, with room for k
        iterations (more room means a new capture)."""
        key = (active_sh, driver.graph_key(backend),
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
                traced=key[-1], flags={})

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
        fused = adam.serves(params.xyz)
        with profiling.annotate("train.upload"):
            bufs.counter.zero_()
            with profiling.marking(bufs.marks, bufs.counter):
                profiling.mark("block")
            if fused and bufs.traced:
                skipped = adam.skip_table(params.xyz.device)
                skipped.zero_()
            bufs.table[:k].copy_(to_device(optimizer.step_scalars(
                iterations, opt_state.step + 1), dev))
            bufs.views[:k].copy_(to_device(np.asarray(view_ids), dev,
                                           torch.int64))
            if mesh is not None:  # rank 0's view order on every rank
                import torch.distributed as dist

                dist.broadcast(bufs.views[:k],
                               dist.get_global_rank(groups[0], 0),
                               group=groups[0])
        with driver.recording_overflow(bufs.flags):
            metrics = loop.run(k)
        opt_state.step += k
        if fused:
            profiling.count("adam.fused_steps", k)
        if bufs.marks is not None:
            with profiling.annotate("train.marks"):
                profiling.add_step_marks(
                    "make_train_scan", family,
                    bufs.marks.times[:k].cpu().numpy(), MARKS, PHASES)
                if fused:
                    for name, n in zip(PARAM_FIELDS, skipped.tolist()):
                        profiling.count(f"adam.skipped.{name}", n)
        return params, opt_state, {n: v.clone() for n, v in metrics.items()}

    return train_block


# Periodic backend re-probe cadence (iterations); module-level so tests can
# shrink it
_REPROBE_EVERY = 250
# A re-probe switches only when the other backend takes below this share
# of the current one's time per iteration
_SWITCH_SHARE = 0.87
# The probe's clock; module-level so tests can substitute a fake one
_clock = time.perf_counter


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _AutoProbe:
    """Each train_joint block's backend and most iterations (log_every).
    backend="auto" runs the dense kernels, probed against `other`, the
    capacity candidate sized on `camera` (none for mixed shapes or a mesh:
    dense alone). A probe is a plan of (side, timed) blocks; a timed block
    synchronises before and after. The first runs four blocks of
    min(10, log_every), dense then the candidate, and keeps the faster.
    Every _REPROBE_EVERY iterations the capacity side is re-sized against
    the live scene (or demoted when nothing fits) and one block is timed
    on each; the loop switches when the other takes below _SWITCH_SHARE
    of the current one's time."""

    def __init__(self, backend: str, params, camera: Optional[Camera],
                 first_iter: int, log_every: int):
        self.camera, self.log_every = camera, log_every
        self.probe_len = max(1, min(10, log_every))
        self.current = backend  # the backend kept
        self.other: Optional[str] = None  # the one probed against it
        if backend == "auto":
            self.current = "pallas"
            if camera is not None:
                with profiling.annotate("train.probe"):
                    self.other = driver.capacity_candidate(params, camera)
        self.plan = [] if self.other is None else [
            ("current", False), ("current", True), ("other", False),
            ("other", True)]
        self.first = bool(self.plan)  # the first probe has not decided
        self.times: dict = {}  # side -> seconds an iteration
        self.next_reprobe = first_iter + 1 + _REPROBE_EVERY

    def next_block(self, it: int, params) -> tuple[str, int]:
        """(backend, most iterations) of the block starting at iteration
        `it`; at a re-probe's start, the capacity side re-sized first."""
        if (not self.plan and self.other is not None
                and it >= self.next_reprobe):
            self._resize(it, params)
        other = self.plan and self.plan[0][0] == "other"
        return (self.other if other else self.current,
                self.probe_len if self.first else self.log_every)

    @contextlib.contextmanager
    def timing_block(self, it: int, n: int, dev):
        """The spans of the block of n iterations starting at `it`
        (`train.probe` around a probe's block), its time per iteration
        reported to the probe at its end. The clock is read inside the
        caller's profile trace: its start, stop and export stay out of the
        probe's time."""
        timed = bool(self.plan) and self.plan[0][1]
        with (profiling.annotate("train.probe") if self.plan
              else contextlib.nullcontext()), \
                profiling.annotate("train.block"):
            if timed:
                _sync(dev)
            t_blk = _clock()
            yield
            if timed:
                _sync(dev)
            per_iter = (_clock() - t_blk) / n
        if self.plan:
            side, _ = self.plan.pop(0)
            if timed:
                self.times[side] = per_iter
            if not self.plan:
                self._decide(it)

    def _resize(self, it: int, params):
        """Re-size the capacity side against the live scene (its
        capacities were sized when it was chosen) and plan the re-probe;
        with no candidate that fits, demote it and skip this window."""
        on_current = driver.is_capacity(self.current)
        if on_current or driver.is_capacity(self.other):
            with profiling.annotate("train.probe"):
                fresh = driver.capacity_candidate(params, self.camera)
            old = self.current if on_current else self.other
            if fresh is None:
                if on_current:
                    self.current, self.other = self.other, self.current
                    profiling.count("train.switches")
                    print("[train] backend auto: demoting binned at "
                          f"iter {it} — required capacities now "
                          "unreasonable for this scene", flush=True)
                self.next_reprobe = it + _REPROBE_EVERY
                return
            if driver.capacities_grew(old, fresh):
                if on_current:
                    self.current = fresh
                else:
                    self.other = fresh
                profiling.count("train.resizes")
                print(f"[train] backend auto: binned capacities resized "
                      f"{old} -> {fresh} at iter {it}", flush=True)
        self.plan = [("current", True), ("other", True)]
        profiling.count("train.reprobes")

    def _decide(self, it: int):
        """The probe's last block, starting at `it`, has run: keep the
        faster backend (the first probe's current is dense)."""
        t_cur, t_other = self.times["current"], self.times["other"]
        switch = t_other < (1.0 if self.first else _SWITCH_SHARE) * t_cur
        if switch:
            self.current, self.other = self.other, self.current
        if self.first:
            self.first = False
            t = {"dense": t_cur, "binned": t_other}
            win, lose = ("binned", "dense") if switch else ("dense", "binned")
            print(f"[train] backend auto: {win} ({t[win] * 1e3:.0f} ms/iter) "
                  f"beats {lose} ({t[lose] * 1e3:.0f} ms/iter)", flush=True)
            return
        if switch:
            profiling.count("train.switches")
            print(f"[train] backend auto: switching at iter {it} — "
                  f"other backend {t_other * 1e3:.0f} ms/iter beats "
                  f"current {t_cur * 1e3:.0f}", flush=True)
        self.next_reprobe = it + _REPROBE_EVERY


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
    two give the same bits on the CPU. _AutoProbe picks each block's
    backend and length; under auto, the view order, iteration numbers and
    SH ramp are those of a fixed backend.
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

    probe = _AutoProbe(trainer_cfg.backend, params,
                       None if mixed_shapes or mesh is not None
                       else cameras[0], first_iter, log_every)
    if use_scan:
        stacked = stack_cameras(cameras)
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        block_fns: dict = {}  # backend name -> make_train_scan block

        def block_fn(name: str):
            """The block function of `name`; those of names no longer in
            play are dropped with their graphs."""
            for stale in set(block_fns) - {name, probe.current, probe.other}:
                del block_fns[stale]
            if name not in block_fns:
                block_fns[name] = make_train_scan(
                    optimizer, stacked, bg, opt_cfg.lambda_dssim, name,
                    trainer_cfg.chunk, mesh=mesh,
                    shard_axis=trainer_cfg.shard_axis, pool=pool)
            return block_fns[name]

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
        name, most = probe.next_block(it, params)
        end = min(end, it + most - 1)
        active_sh = min(it // interval, params.max_sh_degree)
        profiling.count("train.iterations."
                        + (driver.family(name) if use_scan else "eager"),
                        end - it + 1)
        with profiling.profile_trace(trainer_cfg.profile_dir,
                                     enabled=block_idx == 1), \
                probe.timing_block(it, end - it + 1, dev):
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
