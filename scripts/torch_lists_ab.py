#!/usr/bin/env python3
"""Time the port's list compositors (binned K3/K4, tiled K5/K6) from one or
more source trees, in turns, inside one process group on one card, so that
two versions are compared under the same clocks and power limit.

    python3 scripts/torch_lists_ab.py TREE_A TREE_B        # runs A B B A
    python3 scripts/torch_lists_ab.py .                    # one tree

Each TREE is a checkout of this repository (for a parent commit: `git
archive <commit> | tar -x -C build/parent`). For each turn a fresh process
imports `instantsplat_tpu_torch` and `chip_smoke` from that tree, builds its
kernels, writes chip_smoke's synthetic scene (100k points, 512x384), trains
it 200 iterations with --backend pallas, and then, for the initial and the
trained splats of view 0 and for each of the two backends, measures through
the public autograd entries `composite_tiles_binned` and
`composite_tiles_2d`, which are the same in every tree, with the capacities
the tree's own requirements give for those splats:

- CUDA-event ms of the forward and of forward + backward, list build (keys,
  sort, searchsorted) and every small launch around the kernels included;
- device ms per call by kernel (torch.profiler): k3 .. k6, told apart by
  the kernel template's arguments (rows 4 = binned, 8 = tiled; forward or
  backward), and k1_rects where a tree runs it in front of them.

Prints one JSON line per turn; needs a CUDA card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPS = 20
# (direction, rows of the segment) of the kernel template -> kernel
KERNEL_OF = {("forward", 4): "k3", ("backward", 4): "k4",
             ("forward", 8): "k5", ("backward", 8): "k6"}


def kernel_key(name: str) -> str | None:
    """k3 .. k6 or k1_rects for a profiled device kernel's name."""
    m = re.search(r"lists_(forward|backward)_kernel<\s*(\d+)", name)
    if m:
        return KERNEL_OF.get((m.group(1), int(m.group(2))))
    return "k1_rects" if "k1_rects" in name else None


def measure(tree: Path) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from instantsplat_tpu_torch.ops.rasterize_pallas_binned import (
        composite_tiles_binned)
    from instantsplat_tpu_torch.ops.rasterize_pallas_tiled import (
        composite_tiles_2d)
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(4)
    g_rgb = torch.as_tensor(rng.normal(size=(cs.H, cs.W, 3)),
                            dtype=torch.float32, device=dev)
    g_alpha = torch.as_tensor(rng.normal(size=(cs.H, cs.W)),
                              dtype=torch.float32, device=dev)
    out = {"tree": str(tree), "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        scene = Path(tmp) / "scene"
        cs.write_scene(scene)
        initial, cams = cs.initial_params(scene, dev)
        trained = cs.train_run(scene, Path(tmp) / "out", "pallas", 100)[0]
    cam = cams[0]
    entries = {"binned": composite_tiles_binned, "tiled": composite_tiles_2d}
    for tag, params in (("initial", initial), ("trained", trained)):
        with torch.no_grad():
            packed, _ = prepare_packed_splats(
                params, params.get_pose(0), cam.fx, cam.fy, cam.cx, cam.cy,
                1.0, params.max_sh_degree, cs.H, cs.W)
        p = packed.contiguous().requires_grad_(True)
        for kind, backend in cs.sized_backends(packed, cs.H, cs.W).items():
            caps = [int(c) for c in backend.split(":")[1:]]

            def fwd():
                return entries[kind](p, cs.H, cs.W, None, *caps)

            def fwd_bwd():
                o = fwd()
                torch.autograd.grad((o.rgb * g_rgb).sum()
                                    + (o.alpha * g_alpha).sum()
                                    + (o.depth * g_alpha).sum() * 1e-2, [p])

            res = {"backend": backend, "fwd_ms": cs.cuda_ms(fwd, REPS),
                   "fwd_bwd_ms": cs.cuda_ms(fwd_bwd, REPS)}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    fwd_bwd()
                torch.cuda.synchronize()
            for e in prof.events():
                key = kernel_key(e.name)
                if e.device_type == DeviceType.CUDA and key:
                    res[key + "_ms"] = res.get(key + "_ms", 0.0) + \
                        e.time_range.elapsed_us() / 1e3 / REPS
            out[f"{tag} {kind}"] = res
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(Path(sys.argv[2]).resolve())), flush=True)
        return
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if not trees:
        raise SystemExit(__doc__)
    turns = trees + trees[::-1] if len(trees) > 1 else trees
    for tree in turns:
        subprocess.run([sys.executable, __file__, "--measure", str(tree)],
                       check=True)


if __name__ == "__main__":
    main()
