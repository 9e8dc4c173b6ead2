#!/usr/bin/env python3
"""Time the port's dense compositor from one or more source trees, in turns,
inside one process group on one card, so that two versions are compared
under the same clocks and power limit.

    python3 scripts/torch_dense_ab.py TREE_A TREE_B        # runs A B B A
    python3 scripts/torch_dense_ab.py .                    # one tree

Each TREE is a checkout of this repository (for a parent commit: `git
archive <commit> | tar -x -C build/parent`). For each turn a fresh process
imports `instantsplat_tpu_torch` and `chip_smoke` from that tree, builds its
kernels, writes chip_smoke's synthetic scene (100k points, 512x384), trains
it 200 iterations with --backend pallas, and then, for the initial and the
trained splats of view 0, measures through the public autograd entry
`rasterize_pallas.composite_packed`, which is the same in every tree:

- CUDA-event ms of the forward and of forward + backward (rectangles, K1,
  K2 and whatever small launches surround them);
- device ms by kernel name (torch.profiler) of every kernel named k1_* or
  k2_*, per call.

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


def measure(tree: Path) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(4)
    g_acc = torch.as_tensor(rng.normal(size=(4, cs.H, cs.W)),
                            dtype=torch.float32, device=dev)
    g_tfin = torch.as_tensor(rng.normal(size=(cs.H, cs.W)),
                             dtype=torch.float32, device=dev)
    out = {"tree": str(tree), "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        scene = Path(tmp) / "scene"
        cs.write_scene(scene)
        initial, cams = cs.initial_params(scene, dev)
        trained = cs.train_run(scene, Path(tmp) / "out", "pallas", 100)[0]
    cam = cams[0]
    for tag, params in (("initial", initial), ("trained", trained)):
        with torch.no_grad():
            packed, _ = prepare_packed_splats(
                params, params.get_pose(0), cam.fx, cam.fy, cam.cx, cam.cy,
                1.0, params.max_sh_degree, cs.H, cs.W)
        p = packed.contiguous().requires_grad_(True)

        def fwd():
            return RP.composite_packed(p, cs.H, cs.W)

        def fwd_bwd():
            acc, tfin = fwd()
            torch.autograd.grad((acc * g_acc).sum() + (tfin * g_tfin).sum(),
                                [p])

        res = {"fwd_ms": cs.cuda_ms(fwd, REPS),
               "fwd_bwd_ms": cs.cuda_ms(fwd_bwd, REPS)}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fwd_bwd()
            torch.cuda.synchronize()
        for e in prof.events():
            kernel = re.search(r"\bk[12]_\w+", e.name)
            if e.device_type == DeviceType.CUDA and kernel:
                key = kernel.group(0) + "_ms"
                res[key] = res.get(key, 0.0) + \
                    e.time_range.elapsed_us() / 1e3 / REPS
        out[tag] = res
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
