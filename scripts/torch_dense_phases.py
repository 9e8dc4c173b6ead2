#!/usr/bin/env python3
"""Where a CTA of the compositor kernels K1 .. K6 spends its cycles.

    python3 scripts/torch_dense_phases.py

Builds csrc/rasterize.cu and csrc/rasterize_lists.cu with -DPHASE_CLOCKS
(thread 0 of every CTA then adds the clock64() cycles of each phase to a
device array), writes chip_smoke's synthetic scene (100k points, 512x384),
trains it 200 iterations with --backend pallas, and launches K1 and K2, K3
and K4 (binned), K5 and K6 (tiled) once each on view 0's trained splats, the
list kernels over lists sized for them. Prints, per kernel, the mean cycles
per CTA in each phase and the share of the sum, then the kernels' CUDA-event
times with the probes in (they cost a few percent). Thread 0 belongs to the
warp of the CTA's top-left 8x4 block, so "waiting" is that warp's wait for
the CTA's other warps. Needs a CUDA card.
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
    probed = {}
    for src in cs.SOURCES:
        out = cuda_build.BUILD_ROOT / "phase_clocks" / \
            f"lib{Path(src).stem}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                        "-DPHASE_CLOCKS", "-I", str(cuda_build.CSRC), "-o",
                        str(out), str(cuda_build.CSRC / src)], check=True,
                       capture_output=True)
        probed[src] = out
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
    # from here on the wrappers launch the probed libraries
    libs = {}
    for src, path in probed.items():
        libs[src] = cuda_build._loaded[src] = ctypes.CDLL(str(path))
        libs[src].phase_clocks_read.argtypes = [ctypes.c_void_p]
    clocks = (ctypes.c_ulonglong * 8)()
    rng = np.random.default_rng(4)
    g_acc = torch.as_tensor(rng.normal(size=(4, cs.H, cs.W)),
                            dtype=torch.float32, device=dev)
    g_tfin = torch.as_tensor(rng.normal(size=(cs.H, cs.W)),
                             dtype=torch.float32, device=dev)
    backends = {"dense": "pallas", **cs.sized_backends(packed, cs.H, cs.W)}
    for kind, backend in backends.items():
        (kf, kb), _, k_fwd, k_bwd, listed = cs.backend_paths(
            backend, packed, cs.H, cs.W)
        _, tfin, lc = k_fwd()
        gtu = (g_tfin * tfin).contiguous()
        if listed is None:
            lib = libs["rasterize.cu"]
            n_ctas = -(-cs.W // RP.TILE) * -(-cs.H // RP.TILE)
        else:
            lib = libs["rasterize_lists.cu"]
            _, geom, cta_cols = listed
            n_ctas = geom.n_seg * (geom.seg_w // cta_cols)
        for name, fn in ((kf, k_fwd),
                         (kb, lambda: k_bwd(g_acc, gtu, tfin, lc))):
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
            print(f"{name} sum {total / n_ctas:.0f} cycles/CTA over "
                  f"{n_ctas} CTAs ({kind}: {backend}); "
                  f"{cs.cuda_ms(fn, 20):.4f} ms with the probes in")


if __name__ == "__main__":
    main()
