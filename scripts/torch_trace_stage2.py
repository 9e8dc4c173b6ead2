#!/usr/bin/env python3
"""Stage 2 as the benchmark trains it, with the program's tracing
(instantsplat_tpu_torch/utils/profiling.py): what tracing costs, and what
its spans, counters and device marks read.

    python3 scripts/torch_trace_stage2.py --workload gs_sh3.train_3v \\
        --seed 3100000001 --scenes 8 --out build/trace_3v.json

Takes the cell's configuration and traffic from BENCHMARK.json and its
scene generator and `train_scene` from benchmark/entries/gs_train.py.

1. Cost: after a warm-up scene, trains --scenes whole scenes with tracing
   off and on in turns (off, on, on, off, ...), each a fresh run_training
   call as cli.train composes it, and prints each scene's wall time, the
   medians' ratio, and for a traced scene its counters and span seconds.
2. Readings (--bench-seconds > 0): the benchmark entry's own traced run
   (`run(..., traced=True)`: its window of whole scenes, the two profiled
   windows, the reference's check) with the program's tracing switched on
   before its set-up. From its record and the program's table it prints
   what per-layer readers of the table would read: the phases of the
   traced last whole log block per iteration (`frontend`, `raster`,
   `loss`, `adam`, `replay_gap`), and per scene (the mean over the
   window's scenes after the first, or the first where it is the only
   one) the KNN's device seconds, the captures' (steploop.warmup +
   steploop.capture), the probe's and the writes' host seconds; each
   scene's counters and its seconds in no span (train.run's and
   train.joint's self time); and the checks of the marks against the
   device trace's layers.

Everything goes to --out as JSON; the last line of standard output is
its summary. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PHASES = ("frontend", "raster", "loss", "adam", "replay_gap")


def _diff(after: dict, before: dict) -> dict:
    """What the table gained between two snapshots: spans (count, host_s,
    self_s, device_s), counters, and phase seconds and steps by family."""
    spans = {}
    for name, s in after["spans"].items():
        b = before["spans"].get(name, {})
        d = {k: (s[k] or 0.0) - (b.get(k) or 0.0)
             for k in ("count", "host_s", "self_s", "device_s")}
        if d["count"]:
            spans[name] = d
    counters = {k: v - before["counters"].get(k, 0)
                for k, v in after["counters"].items()
                if v != before["counters"].get(k, 0)}
    phases = {}
    for fam, ph in after["phases"].get("make_train_scan", {}).items():
        old = before["phases"].get("make_train_scan", {}).get(fam, {})
        got = {p: dict(seconds=v["seconds"] - old.get(p, {}).get(
                   "seconds", 0.0),
                       steps=v["steps"] - old.get(p, {}).get("steps", 0))
               for p, v in ph.items()}
        if got["adam"]["steps"]:
            phases[fam] = got
    return dict(spans=spans, counters=counters, phases=phases)


def _host(d: dict, *names) -> float:
    return sum(d["spans"].get(n, {}).get("host_s", 0.0) for n in names)


def scene_summary(d: dict, wall: float) -> dict:
    """A scene's program readings from its table difference."""
    unspanned = (d["spans"].get("train.run", {}).get("self_s", 0.0)
                 + d["spans"].get("train.joint", {}).get("self_s", 0.0))
    return dict(
        wall_s=wall,
        knn_device_s=d["spans"].get("train.knn", {}).get("device_s"),
        knn_host_s=_host(d, "train.knn"),
        capture_s=_host(d, "steploop.warmup", "steploop.capture"),
        probe_s=_host(d, "train.probe"),
        write_s=_host(d, "train.write"),
        read_s=_host(d, "train.read"),
        log_s=_host(d, "train.log"),
        unspanned_s=unspanned, unspanned_share=unspanned / wall,
        counters={k: v for k, v in d["counters"].items()
                  if not k.startswith("kernel.")},
        spans={k: {m: round(v, 6) for m, v in s.items()}
               for k, s in d["spans"].items()})


def cost(entry, cell, seed: int, scenes: int, tmp: Path, profiling,
         device="cuda"):
    """Whole scenes with tracing off and on in turns (ABBA)."""
    cfg, traffic = cell.config, cell.traffic
    sc = entry.make_scenes(tmp, seed, traffic, cfg)
    entry.train_scene(sc[0], tmp / "warm", dict(
        cfg, iterations=entry.WARMUP_ITERATIONS), device)
    out = []
    for i in range(scenes):
        traced = i % 4 in (1, 2)
        profiling.enable(traced)
        before = profiling.snapshot()
        wall, _ = entry.train_scene(sc[(i + 1) % len(sc)], tmp / f"o{i}",
                                    cfg, device)
        d = _diff(profiling.snapshot(), before)
        profiling.enable(False)
        out.append(dict(traced=traced, wall_s=wall,
                        ms_per_iter=wall * 1e3 / cfg["iterations"],
                        **({"scene": scene_summary(d, wall)}
                           if traced else {})))
        print(f"[trace] scene {i} tracing {'on' if traced else 'off'}: "
              f"{wall:.4f} s", flush=True)
    on = [s["ms_per_iter"] for s in out if s["traced"]]
    off = [s["ms_per_iter"] for s in out if not s["traced"]]
    return dict(scenes=out, median_on=statistics.median(on),
                median_off=statistics.median(off),
                overhead=statistics.median(on) / statistics.median(off) - 1)


def readings(entry, cell, seed: int, seconds: float, profiling):
    """The benchmark entry's traced run with the program's tracing on."""
    import benchmark.core.trace as tr
    from benchmark.core import manifest

    per_scene, block = [], {}
    real_scene = entry.train_scene

    def train_scene(scene, out, cfg, device="cuda", on_log=None):
        before = profiling.snapshot()
        wall, logs = real_scene(scene, out, cfg, device, on_log=on_log)
        per_scene.append(scene_summary(_diff(profiling.snapshot(), before),
                                       wall))
        return wall, logs

    real_start, real_stop = tr.Profiler.start, tr.Profiler.stop

    def start(self):
        if self.path.name == "block.json":
            block["before"] = profiling.snapshot()
        real_start(self)

    def stop(self):
        real_stop(self)
        if self.path.name == "block.json":
            block["diff"] = _diff(profiling.snapshot(), block["before"])

    entry.train_scene, tr.Profiler.start, tr.Profiler.stop = (
        train_scene, start, stop)
    profiling.reset()
    profiling.enable(True)
    try:
        res = entry.run(cell, seed, seconds, True, time.perf_counter(),
                        "cuda")
    finally:
        profiling.enable(False)
        entry.train_scene, tr.Profiler.start, tr.Profiler.stop = (
            real_scene, real_start, real_stop)
    rec = res.record
    n = rec["block_iterations"]
    ph = {p: sum(f[p]["seconds"] for f in block["diff"]["phases"].values())
          * 1e3 / n for p in PHASES}
    window = per_scene[1:]  # the first call is the set-up's warm-up scene
    mean_of = window[1:] or window[:1]

    def mean(key):
        vals = [s[key] for s in mean_of]
        return None if None in vals else statistics.mean(vals)

    metrics = {f"train.{p}_ms": v for p, v in ph.items()}
    metrics.update({"train.knn_s": mean("knn_device_s"),
                    "train.capture_s": mean("capture_s"),
                    "train.probe_s": mean("probe_s"),
                    "train.write_s": mean("write_s")})
    old = {m: manifest.metric_reader(m)(rec) for m in (
        "train.prep_s", "train.torch_kernels_ms", "train.sort_ms",
        "train.compositor_ms", "train.block_idle_pct")}
    block_ms = rec["block_s"] * 1e3 / n
    sort, comp = old["train.sort_ms"], old["train.compositor_ms"]
    checks = dict(
        phases_over_block_wall=sum(ph.values()) / block_ms,
        raster_covers_sort_and_compositor=ph["raster"] >= sort + comp,
        rest_over_torch_kernels=(ph["frontend"] + ph["loss"] + ph["adam"]
                                 + ph["raster"] - sort - comp)
        / old["train.torch_kernels_ms"],
        knn_within_prep=(metrics["train.knn_s"] or 0.0) <= old["train.prep_s"],
        unspanned_share_max=max(s["unspanned_share"] for s in window))
    return dict(correct=res.correct, checks_vs_reference=res.checks,
                metrics=metrics, existing=old, block_ms_per_iter=block_ms,
                block_counters=block["diff"]["counters"],
                block_spans=block["diff"]["spans"], acceptance=checks,
                idle_gaps=res.breakdown["idle_gaps"], scenes=window,
                warmup_scene=per_scene[0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--scenes", type=int, default=8,
                    help="scenes of the cost run (0: none)")
    ap.add_argument("--bench-seconds", type=float, default=51.0,
                    help="--seconds of the traced benchmark run (0: none)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from benchmark.core import device, manifest
    from instantsplat_tpu_torch.ops import cuda_build
    from instantsplat_tpu_torch.utils import profiling

    cell = manifest.cell(args.workload)
    entry = cell.entry()
    for src in ("rasterize.cu", "rasterize_lists.cu", "trace.cu"):
        cuda_build.load_library(src)
    result = dict(workload=args.workload, seed=args.seed, card=device.smi())
    print(f"[trace] card: {result['card']}", flush=True)
    with tempfile.TemporaryDirectory(prefix="trace-gs-") as tmp:
        if args.scenes:
            result["cost"] = cost(entry, cell, args.seed, args.scenes,
                                  Path(tmp), profiling)
    if args.bench_seconds:
        result["readings"] = readings(entry, cell, args.seed,
                                      args.bench_seconds, profiling)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    summary = dict(workload=args.workload, card=result["card"])
    if "cost" in result:
        summary["cost"] = {k: result["cost"][k] for k in (
            "median_on", "median_off", "overhead")}
        summary["cost"]["ms_per_iter"] = [
            (s["traced"], round(s["ms_per_iter"], 4))
            for s in result["cost"]["scenes"]]
    if "readings" in result:
        r = result["readings"]
        summary.update({k: r[k] for k in (
            "correct", "metrics", "existing", "block_ms_per_iter",
            "acceptance", "idle_gaps")})
        summary["scenes"] = [{k: s[k] for k in (
            "wall_s", "unspanned_s", "unspanned_share", "counters")}
            for s in r["scenes"]]
    print(json.dumps(summary, default=str), flush=True)


if __name__ == "__main__":
    main()
