"""Stage 2 as InstantSplat users run it: whole 1000-iteration scenes back to
back, each a fresh `run_training` call composed as `cli.train` composes it
(backend auto, captured blocks of log_every iterations, the per-point and
pose optimisers of the configuration).

Set-up writes the traffic's scene folders from the seed under TMPDIR (the
Gaussians are the points stage 1 keeps for the views: scenes/relief.py)
and trains one of them for WARMUP_ITERATIONS (the auto probe's blocks of
both backends, their captures, one more block). The window then
trains round(--seconds / the traffic's `scene_s`) whole scenes, cycling
over the folders. In the window the first block of each backend family
(the dense kernels, the tiled K5/K6, the binned K3/K4; `FirstSteps`) runs
its first six steps as single-step calls, with the state kept around
them. With --trace, the window's first scene runs with two windows of it
under torch.profiler (`TracedWindows`).

The check, once the window has closed and the program's state is freed:
for each split block the plain reference (reference/gs_plain.py) follows
steps 1-3 from the scene's own start (the dense block at iteration 1) or
from the program's state at the block's start, and steps 4-6 (graph
replays) from the program's state after step 3. Compared, the worst over
the blocks: each step's loss, each phase's first gradient (from the
program's moments) and each phase's parameter change, by the worst leaf.
"""

from __future__ import annotations

import dataclasses
import shutil
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.core import trace as tr
from benchmark.core.outcome import Outcome
from benchmark.counts import gs_step
from benchmark.reference import gs_plain
from benchmark.scenes import relief

SPLIT_STEPS = 6  # steps 1-3 eager warm-up steps, 4-6 graph replays
# the warm-up scene's iterations: the auto probe's four blocks of 10 (both
# backends, their captures) and one more block
WARMUP_ITERATIONS = 50
BETA1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone; its change is not compared
NOUGHT_SHARE = 1e-3
# the program's optimisation flags a cli.train user passes for this config
CLI_FLAGS = ("position_lr_init", "position_lr_final", "position_lr_delay_mult",
             "position_lr_max_steps", "feature_lr", "opacity_lr",
             "scaling_lr", "rotation_lr", "lambda_dssim")


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def family(backend: str) -> str:
    """The kernels a backend name runs: "pallas" (KR, K1, K2),
    "pallas-tiled" (K5, K6) or "pallas-binned" (K3, K4), whatever its
    capacities."""
    return backend.split(":")[0]


class FirstSteps:
    """Wraps `trainer.make_train_scan`: the first block call of each
    backend family that the window runs (`family`; the auto probe's
    capacity block and a re-probe's included) runs its first SPLIT_STEPS
    steps as single-step calls, with the state kept around them, on the
    device, in `blocks[family]`. `scene` is the scene being trained."""

    KEEP = {0: ("p", "m", "v"), 1: ("m",), 3: ("p", "m", "v"), 4: ("m",),
            6: ("p",)}

    def __init__(self):
        self.blocks, self.scene = {}, None

    def wrap(self, make):
        rec = self

        def make_train_scan(*a, **kw):
            block = make(*a, **kw)
            fam = family(kw["backend"] if "backend" in kw else a[4])

            def train_block(params, opt_state, view_ids, iterations,
                            active_sh):
                if (fam in rec.blocks or active_sh != 0
                        or len(iterations) < SPLIT_STEPS):
                    return block(params, opt_state, view_ids, iterations,
                                 active_sh)
                from instantsplat_tpu_torch.models.gaussians import \
                    PARAM_FIELDS

                split = rec.blocks[fam] = Split(
                    scene=rec.scene, first=int(iterations[0]))

                def keep(j):
                    parts = dict(p={f: getattr(params, f)
                                    for f in PARAM_FIELDS},
                                 m=opt_state.m, v=opt_state.v)
                    for part in rec.KEEP.get(j, ()):
                        split.state[(j, part)] = {
                            k: t.detach().clone()
                            for k, t in parts[part].items()}

                keep(0)
                out = None
                for j in range(SPLIT_STEPS):
                    params, opt_state, out = block(
                        params, opt_state, view_ids[j:j + 1],
                        iterations[j:j + 1], active_sh)
                    split.losses.append(float(out["loss"]))
                    split.views.append(int(view_ids[j]))
                    keep(j + 1)
                if len(iterations) > SPLIT_STEPS:
                    params, opt_state, out = block(
                        params, opt_state, view_ids[SPLIT_STEPS:],
                        iterations[SPLIT_STEPS:], active_sh)
                return params, opt_state, out

            return train_block

        return make_train_scan


@dataclasses.dataclass
class Split:
    """One family's split block: its scene, its first iteration, the
    program's losses and views of the split steps, and the state kept
    ((step, "p" | "m" | "v") -> {leaf: tensor}; step 0 is the block's
    start)."""

    scene: object
    first: int
    losses: list = dataclasses.field(default_factory=list)
    views: list = dataclasses.field(default_factory=list)
    state: dict = dataclasses.field(default_factory=dict)


class TracedWindows:
    """The traced scene's two profiled windows: from the scene's start to
    its first log (`bench.prep`: read, KNN, the auto probe, captures, the
    first iterations), and the first block that holds iteration `at` (the
    last whole log block; `bench.block`, between two synchronisations,
    with the state at its start kept). A whole scene's ~1.8 M kernel
    events would take minutes to export and read."""

    def __init__(self, tmp: Path, at: int, log_every: int):
        self.prep = tr.Profiler(tmp / "prep.json")
        self.block = tr.Profiler(tmp / "block.json")
        self.at, self.log_every = at, log_every
        self.state, self.views, self._span = None, None, None

    def begin(self):
        self.prep.start()
        self._span = torch.profiler.record_function("bench.prep")
        self._span.__enter__()

    def on_log(self, it: int):
        if it == self.log_every:
            torch.cuda.synchronize()
            self._span.__exit__(None, None, None)
            self.prep.stop()

    def wrap(self, make):
        rec = self

        def make_train_scan(*a, **kw):
            block = make(*a, **kw)

            def train_block(params, opt_state, view_ids, iterations,
                            active_sh):
                if (rec.state is not None or not
                        int(iterations[0]) <= rec.at <= int(iterations[-1])):
                    return block(params, opt_state, view_ids, iterations,
                                 active_sh)
                from instantsplat_tpu_torch.models.gaussians import \
                    PARAM_FIELDS

                rec.state = _cpu({f: getattr(params, f)
                                  for f in PARAM_FIELDS})
                rec.views = [int(v) for v in view_ids]
                rec.block.start()
                with torch.profiler.record_function("bench.block"):
                    torch.cuda.synchronize()
                    out = block(params, opt_state, view_ids, iterations,
                                active_sh)
                    torch.cuda.synchronize()
                rec.block.stop()
                return out

            return train_block

        return make_train_scan


class patched_scan:
    """trainer.make_train_scan wrapped by each recorder's `wrap` (None
    skipped)."""

    def __init__(self, *recorders):
        self.recorders = [r for r in recorders if r is not None]

    def __enter__(self):
        from instantsplat_tpu_torch.pipelines import trainer

        self.orig = make = trainer.make_train_scan
        for r in self.recorders:
            make = r.wrap(make)
        trainer.make_train_scan = make

    def __exit__(self, *exc):
        from instantsplat_tpu_torch.pipelines import trainer

        trainer.make_train_scan = self.orig


def train_scene(scene: relief.Scene, out: Path, cfg: dict, device="cuda",
                on_log=None):
    """One stage-2 run of `scene` into `out`, composed as cli.train composes
    it. -> (wall seconds, {logged iteration: host clock at its log});
    on_log(iteration) is called at each log."""
    from instantsplat_tpu_torch.cli import train as cli_train
    from instantsplat_tpu_torch.pipelines import config as C
    from instantsplat_tpu_torch.pipelines.train_pipeline import run_training
    from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig

    argv = ["-s", str(scene.root), "-m", str(out), "--n_views",
            str(scene.n_views), "--iterations", str(cfg["iterations"]),
            "--sh_degree", str(cfg["sh_degree"]), "--pp_optimizer",
            "--optim_pose", "--quiet", "--device", device,
            "--log_every", str(cfg["log_every"]), "--backend", cfg["backend"]]
    for key in CLI_FLAGS:
        argv += [f"--{key}", repr(cfg[key])]
    args = cli_train.build_parser().parse_args(argv)
    model = C.extract_group(args, C.ModelParams)
    opt = C.make_opt_config(args)
    trainer = TrainerConfig(iterations=args.iterations,
                            white_background=model.white_background,
                            backend=args.backend, log_every=args.log_every,
                            n_devices=1, shard_axis=args.shard_axis)
    logs = {}

    def progress(it, _metrics):
        logs[it] = time.perf_counter()
        if on_log is not None:
            on_log(it)

    t0 = time.perf_counter()
    run_training(model, opt, trainer, progress_cb=progress, device=device)
    return time.perf_counter() - t0, {k: v - t0 for k, v in logs.items()}


def prep_seconds(logs: dict, iterations: int, log_every: int) -> float:
    """A scene's wall time up to its first log, less as many iterations at
    the pace of the iterations after it."""
    first, last = log_every, iterations
    pace = (logs[last] - logs[first]) / (last - first)
    return logs[first] - first * pace


def make_scenes(tmp: Path, seed: int, traffic: dict, cfg: dict) -> list:
    """The traffic's scene folders from `seed`: one geometry (the views and
    the points stage 1 keeps, the same for every seed), each folder its
    own texture, pose errors and confidences."""
    geo = relief.geometry(traffic["n_views"], cfg["height"], cfg["width"],
                          traffic["arc_rad"], traffic["depth_thre"])
    seeds = np.random.SeedSequence(seed).generate_state(
        traffic["scene_folders"], dtype=np.uint64)
    return [relief.make_scene(tmp / f"scene{k}", int(s), geo)
            for k, s in enumerate(seeds)]


# --------------------------------------------------------------------------
# the check
# --------------------------------------------------------------------------


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def _worst_gap(prog: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in leaves), default=0.0)


def split_readings(split: Split, cfg: dict, device) -> dict:
    """The numbers compared for one split block of the program against the
    float32 reference: steps 1-3 from the scene's own start when the
    block starts the scene, else from the program's state at the block's
    start; steps 4-6 (graph replays) from the program's state after step
    3."""
    scene, it0, s = split.scene, split.first, split.state
    extent = gs_plain.camera_extent(scene)
    ppl = gs_plain.per_point_lr(scene.confidence, device)
    views = gs_plain.view_order(scene.n_views, it0 - 1 + SPLIT_STEPS)[
        it0 - 1:]
    its = list(range(it0, it0 + SPLIT_STEPS))

    def dev(part, j):
        return {k: t.to(device=device, copy=True)
                for k, t in s[(j, part)].items()}

    if it0 == 1:
        leaves = gs_plain.initial_state(scene, cfg["sh_degree"],
                                        cfg["init_opacity"], device)
        m = {k: torch.zeros_like(t) for k, t in leaves.items()}
        v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    else:
        leaves, m, v = dev("p", 0), dev("m", 0), dev("v", 0)
    start = {k: t.clone() for k, t in leaves.items()}
    loss1, g1 = gs_plain.follow(leaves, m, v, it0, views[:3], its[:3],
                                scene, cfg, extent, ppl)
    ch1 = _norms({k: leaves[k].float() - start[k].float() for k in leaves})
    leaves, m, v = dev("p", 3), dev("m", 3), dev("v", 3)
    loss2, g4 = gs_plain.follow(leaves, m, v, it0 + 3, views[3:], its[3:],
                                scene, cfg, extent, ppl)
    ch2 = _norms({k: leaves[k].float() - s[(3, "p")][k] for k in leaves})
    del leaves, m, v, start

    def first_grad(j):  # the gradient Adam took at step j + 1
        return _norms({k: (s[(j + 1, "m")][k] - BETA1 * s[(j, "m")][k])
                       / (1 - BETA1) for k in s[(j + 1, "m")]})

    pg1, pg4 = first_grad(0), first_grad(3)
    pch1 = _norms({k: s[(3, "p")][k] - s[(0, "p")][k] for k in s[(0, "p")]})
    pch2 = _norms({k: s[(6, "p")][k] - s[(3, "p")][k] for k in s[(3, "p")]})
    r1, r4 = _norms(g1), _norms(g4)
    moved = []
    for r in (r1, r4):
        med = statistics.median(r.values())
        moved.append([k for k in r if r[k] >= NOUGHT_SHARE * med])
    ref_losses = loss1 + loss2
    leaf_gaps = {k: max(abs(p[k] - r[k]) / max(r[k], 1e-30)
                        for p, r in ((pg1, r1), (pg4, r4)))
                 for k in r1}
    return dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(split.losses,
                                                          ref_losses)),
        grad_gap=max(_worst_gap(pg1, r1, r1), _worst_gap(pg4, r4, r4)),
        change_gap=max(_worst_gap(pch1, ch1, moved[0]),
                       _worst_gap(pch2, ch2, moved[1])),
        first=it0, views_program=split.views, views_reference=views,
        losses_program=split.losses, losses_reference=ref_losses,
        left_out=sorted(set(r1) - set(moved[0]) | set(r4) - set(moved[1])),
        leaf_grad_gaps=leaf_gaps)


NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def readings(first: FirstSteps, cfg: dict, device) -> dict:
    """Each number compared, the worst over the split blocks of every
    family; each family's readings under its name."""
    if not first.blocks:
        raise RuntimeError("no block was split")
    by_family = {fam: split_readings(split, cfg, device)
                 for fam, split in first.blocks.items()}
    out = {k: max(r[k] for r in by_family.values()) for k in NUMBERS}
    out["families"] = by_family
    return out


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


def run(cell, seed: int, seconds: float, traced: bool, t0: float,
        device="cuda") -> Outcome:
    from instantsplat_tpu_torch.ops import cuda_build, rasterize_pallas
    from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop

    cfg, traffic = cell.config, cell.traffic
    iters, log_every = cfg["iterations"], cfg["log_every"]
    tmp = Path(tempfile.mkdtemp(prefix="bench-gs-"))
    try:
        if device == "cuda":
            for src in ("rasterize.cu", "rasterize_lists.cu"):
                cuda_build.load_library(src)
        scenes = make_scenes(tmp, seed, traffic, cfg)
        warm_its = min(WARMUP_ITERATIONS, iters)
        warm_s, _ = train_scene(scenes[0], tmp / "out-warm", dict(
            cfg, iterations=warm_its), device)
        shutil.rmtree(tmp / "out-warm")
        if device == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n = max(1, round(seconds / traffic["scene_s"]))
        print(f"[bench] set-up {setup_s:.3f} s (the warm-up scene of "
              f"{warm_its} iterations {warm_s:.3f} s); "
              f"{len(scenes[0].xyz)} Gaussians; the window trains {n} "
              f"scenes", flush=True)

        first = FirstSteps()
        win = (TracedWindows(tmp, iters - log_every // 2, log_every)
               if traced else None)
        walls, preps = [], []
        w0 = time.perf_counter()
        with patched_scan(first, win):
            for i in range(n):
                first.scene = scenes[(i + 1) % len(scenes)]
                on_log = None
                if win is not None and i == 0:
                    win.begin()
                    on_log = win.on_log
                wall, logs = train_scene(first.scene, tmp / f"out{i}", cfg,
                                         device, on_log=on_log)
                walls.append(wall)
                preps.append(prep_seconds(logs, iters, log_every))
                shutil.rmtree(tmp / f"out{i}", ignore_errors=True)
        if device == "cuda":
            torch.cuda.synchronize()
        window = time.perf_counter() - w0
        peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
        print(f"[bench] window {window:.4f} s over {n} scenes "
              f"(walls {[round(w, 4) for w in walls]}); prep "
              f"{[round(p, 4) for p in preps]} s; split blocks "
              f"{ {f: b.first for f, b in first.blocks.items()} }; replays "
              f"{StepLoop.replays}; launches "
              + ", ".join(f"{k.name} {k.launches}"
                          for k in rasterize_pallas.Kernel.registry),
              flush=True)

        record, busy_s, window_s, breakdown = {}, None, None, None
        if traced:
            record, busy_s, window_s, breakdown = read_traces(
                win, scenes[1 % len(scenes)], preps, device)

        if device == "cuda":
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        r = readings(first, cfg, device)
        print(f"[bench] the reference's check took "
              f"{time.perf_counter() - c0:.3f} s", flush=True)
        for fam, f in r["families"].items():
            print(f"[bench] {fam} from iteration {f['first']}: views "
                  f"program {f['views_program']} reference "
                  f"{f['views_reference']}; losses program "
                  f"{f['losses_program']} reference {f['losses_reference']}"
                  f"; " + ", ".join(f"{k} {f[k]!r}" for k in NUMBERS)
                  + f"; changes not compared (gradient nought to rounding):"
                  f" {f['left_out']}; first-gradient gap by leaf "
                  f"{ {k: float('%.3g' % v) for k, v in f['leaf_grad_gaps'].items()} }",
                  flush=True)
        checks = [(k, r[k], cell.limits[k]) for k in NUMBERS]
        return Outcome(
            end_to_end={"train_ms_per_iter": window * 1e3 / (n * iters),
                        "setup_s": setup_s},
            record=record, attempted=n, failed=0,
            checks=checks, memory_peak_bytes=peak, busy_s=busy_s,
            window_s=window_s, breakdown=breakdown)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def read_traces(win, scene, preps: list, device):
    """The window's first scene's two traced windows (`TracedWindows`) ->
    (the record the per-layer readers take, busy seconds, the traced
    windows' length, the breakdown). Each directory under layers/ gets the
    device seconds of its kernels in each window (`layer_s`)."""
    from benchmark.core.device import peaks
    from benchmark.core.manifest import layer_dirs

    c1 = time.perf_counter()
    prep, blk = tr.Trace(win.prep.path), tr.Trace(win.block.path)
    pw, bw = prep.span("bench.prep"), blk.span("bench.block")
    c2 = time.perf_counter()
    n_gauss = int(win.state["xyz"].shape[0])
    n_params = sum(int(v.numel()) for v in win.state.values())
    leaves = {k: v.to(device) for k, v in win.state.items()}
    pairs_by_view = {view: gs_step.contributing_pairs(
        leaves, view, scene.fx, scene.height, scene.width)
        for view in sorted(set(win.views))}
    del leaves
    c3 = time.perf_counter()
    ops = nbytes = flops = 0.0
    for view in win.views:
        p = pairs_by_view[view]
        o, b = gs_step.compositor_work(p, n_gauss, scene.height, scene.width)
        ops, nbytes = ops + o, nbytes + b
        flops += gs_step.step_flops(p, n_gauss, n_params, scene.height,
                                    scene.width)
    pk = peaks(torch.cuda.get_device_name(0))
    layers = layer_dirs()
    record = dict(
        prep_s=statistics.mean(preps[1:] or preps),
        prep_window_s=pw[1] - pw[0], prep_busy_s=prep.busy(pw),
        prep_device_s=prep.op_seconds(pw),
        block_iterations=len(win.views), block_s=bw[1] - bw[0],
        block_busy_s=blk.busy(bw), block_device_s=blk.op_seconds(bw),
        layer_s={d: dict(prep=prep.layer_seconds(d, pw),
                         block=blk.layer_seconds(d, bw)) for d in layers},
        block_compositor_ops=ops, block_compositor_bytes=nbytes,
        block_flops=flops, peaks=pk)
    breakdown = tr.merged_breakdown([prep.breakdown(pw), blk.breakdown(bw)])
    print(f"[bench] traced: prep window {record['prep_window_s']:.4f} s, "
          f"busy {record['prep_busy_s']:.4f} s; block of "
          f"{record['block_iterations']} iterations {record['block_s']:.6f}"
          f" s, busy {record['block_busy_s']:.6f} s, device seconds by "
          f"layer {record['layer_s']}; contributing pairs per view "
          f"{pairs_by_view}; peaks {pk} (the card's power limit on the "
          f"first line); {len(prep.device) + len(blk.device)} device "
          f"events; reading the traces {c2 - c1:.3f} s, counting pairs "
          f"{c3 - c2:.3f} s, the rest {time.perf_counter() - c3:.3f} s",
          flush=True)
    busy = record["prep_busy_s"] + record["block_busy_s"]
    return (record, busy, record["prep_window_s"] + record["block_s"],
            breakdown)
