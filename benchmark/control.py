"""The controls of a training cell's check: the plain reference put in the
program's place, run wrong on purpose, and read by the same numbers as a
run of the program.

    python3 benchmark/control.py --workload gs_sh3.train_3v \\
        --variant bf16 --seeds 11 12 13

Variants: `bf16` (the reference in bfloat16, the precision below the
configuration's float32), `half` (the loss over half of the batch, the
image's first rows, the mean taken over them). A state left unchanged
reads 1 as the change's gap and needs no run. Each seed prints its
numbers beside the cell's limits; every variant has to fail at least one.
The benchmark's own runs never run this.
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.core import manifest  # noqa: E402
from benchmark.reference import gs_plain  # noqa: E402


def variant_record(entry, scene, cfg, device, dtype, rows_kept=None):
    """A FirstSteps record of the reference run in `dtype` (rows_kept: the
    half-batch fault) over the scene's first SPLIT_STEPS steps, in the
    program's place as the dense kernels' split block."""
    rec = entry.FirstSteps()
    split = rec.blocks["pallas"] = entry.Split(scene=scene, first=1)
    extent = gs_plain.camera_extent(scene)
    ppl = gs_plain.per_point_lr(scene.confidence, device, dtype)
    views = gs_plain.view_order(scene.n_views, entry.SPLIT_STEPS)
    leaves = gs_plain.initial_state(scene, cfg["sh_degree"],
                                    cfg["init_opacity"], device, dtype)
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}

    def keep(j):
        parts = dict(p=leaves, m=m, v=v)
        for part in entry.FirstSteps.KEEP.get(j, ()):
            split.state[(j, part)] = {k: t.float().clone()
                                      for k, t in parts[part].items()}

    keep(0)
    for j, view in enumerate(views):
        losses, _ = gs_plain.follow(leaves, m, v, j + 1, [view], [j + 1],
                                    scene, cfg, extent, ppl, rows_kept)
        split.losses += losses
        split.views.append(view)
        keep(j + 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", choices=("bf16", "half"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    entry = cell.entry()
    cfg = cell.config
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="bench-control-") as tmp:
            scene = entry.make_scenes(Path(tmp), seed, dict(
                cell.traffic, scene_folders=1), cfg)[0]
            dtype = torch.bfloat16 if args.variant == "bf16" else \
                torch.float32
            rows = cfg["height"] // 2 if args.variant == "half" else None
            rec = variant_record(entry, scene, cfg, args.device, dtype, rows)
            r = entry.readings(rec, cfg, args.device)
        fails = [k for k, lim in cell.limits.items() if not r[k] <= lim]
        print(f"[control] {cell.name} {args.variant} seed {seed}: "
              + ", ".join(f"{k} {r[k]!r} (limit {lim!r})"
                          for k, lim in cell.limits.items())
              + f"; fails {fails}; {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
