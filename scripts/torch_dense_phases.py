#!/usr/bin/env python3
"""Where a CTA of the dense kernels K1 and K2 spends its cycles.

    python3 scripts/torch_dense_phases.py

Builds csrc/rasterize.cu with -DPHASE_CLOCKS (thread 0 of every CTA then
adds the clock64() cycles of each phase to a device array), writes
chip_smoke's synthetic scene (100k points, 512x384), trains it 200
iterations with --backend pallas, and launches K1 and K2 once each on view
0's trained splats. Prints, per kernel, the mean cycles per CTA in each
phase and the share of the sum, then the kernels' CUDA-event times with the
probes in (they cost a few percent). Thread 0 belongs to the warp of the
tile's top-left 8x4 block, so "waiting" is that warp's wait for the tile's
other warps. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PHASES = ("scan", "waiting at barriers", "rows and block masks",
          "the warp's list", "compositing / the walk", "flushing sums")


def main():
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from instantsplat_tpu_torch.ops import cuda_build
    from instantsplat_tpu_torch.ops import rasterize_pallas as RP
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    out = cuda_build.BUILD_ROOT / "phase_clocks" / "librasterize.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                    "-DPHASE_CLOCKS", "-o", str(out),
                    str(cuda_build.CSRC / "rasterize.cu")], check=True,
                   capture_output=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        scene = Path(tmp) / "scene"
        cs.write_scene(scene)
        params = cs.train_run(scene, Path(tmp) / "out", "pallas", 100)[0]
        cam = cs.initial_params(scene, dev)[1][0]
    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            params, params.get_pose(0), cam.fx, cam.fy, cam.cx, cam.cy, 1.0,
            params.max_sh_degree, cs.H, cs.W)
    packed = packed.contiguous()
    # from here on the wrappers launch the probed library
    lib = ctypes.CDLL(str(out))
    cuda_build._loaded["rasterize.cu"] = lib
    lib.phase_clocks_read.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 8)()
    rng = np.random.default_rng(4)
    g_acc = torch.as_tensor(rng.normal(size=(4, cs.H, cs.W)),
                            dtype=torch.float32, device=dev)
    g_tfin = torch.as_tensor(rng.normal(size=(cs.H, cs.W)),
                             dtype=torch.float32, device=dev)
    scan = RP.k1_rects(packed, cs.H, cs.W)
    acc, tfin, lc = RP.k1_forward(packed, scan, cs.H, cs.W)
    gtu = (g_tfin * tfin).contiguous()
    launch = {
        "K1": lambda: RP.k1_forward(packed, scan, cs.H, cs.W),
        "K2": lambda: RP.k2_backward(packed, scan, g_acc, gtu, tfin, lc)}
    n_ctas = -(-cs.W // RP.TILE) * -(-cs.H // RP.TILE)
    for name, fn in launch.items():
        fn()  # warm
        if lib.phase_clocks_read(clocks):
            raise SystemExit("phase_clocks_read failed")
        fn()
        if lib.phase_clocks_read(clocks):
            raise SystemExit("phase_clocks_read failed")
        total = sum(clocks[:len(PHASES)])
        for phase, c in zip(PHASES, clocks):
            print(f"{name} {phase:24s} {c / n_ctas:10.0f} cycles/CTA "
                  f"{100 * c / total:5.1f}%")
        print(f"{name} sum {total / n_ctas:.0f} cycles/CTA over {n_ctas} "
              f"CTAs; {cs.cuda_ms(fn, 20):.4f} ms with the probes in")


if __name__ == "__main__":
    main()
