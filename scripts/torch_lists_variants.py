#!/usr/bin/env python3
"""Time variants of the list compositors' source (csrc/rasterize_lists.cu)
against the source as it stands, in turns on one card in one call.

    python3 scripts/torch_lists_variants.py \\
        "BINNED_MIN_CTAS = 6=>BINNED_MIN_CTAS = 5" \\
        "LANE_ENTRIES = 4=>LANE_ENTRIES = 8" ...

Each argument OLD=>NEW makes one variant: the source with every OLD replaced
by NEW (OLD must occur), compiled with the package's nvcc flags into
build/ (ptxas's register and spill lines are printed). The script writes
chip_smoke's synthetic scene (100k points, 512x384), trains it 200
iterations with --backend pallas, builds lists sized for view 0's trained
splats, and then, twice over, loads each library in turn behind the
package's wrappers and prints the device ms of K3, K4, K5 and K6 (20
launches replayed from a CUDA graph), and at the end K1's and K2's for
scale. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = "rasterize_lists.cu"


def main():
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from instantsplat_tpu_torch.ops import cuda_build
    from instantsplat_tpu_torch.render.driver import prepare_packed_splats

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    text = (cuda_build.CSRC / SOURCE).read_text()
    sources = {"as it stands": text}
    for arg in sys.argv[1:]:
        old, sep, new = arg.partition("=>")
        if not sep or old not in text:
            raise SystemExit(f"{arg!r}: expected OLD=>NEW with OLD in "
                             f"csrc/{SOURCE}")
        sources[arg] = text.replace(old, new)
    libs = {}
    for i, (name, src) in enumerate(sources.items()):
        out = cuda_build.BUILD_ROOT / "variants" / str(i) / "lib.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        (out.parent / SOURCE).write_text(src)
        proc = subprocess.run(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(out), str(out.parent / SOURCE)],
            capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "Used" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out))
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
    rng = np.random.default_rng(4)
    g_acc = torch.as_tensor(rng.normal(size=(4, cs.H, cs.W)),
                            dtype=torch.float32, device=dev)
    g_tfin = torch.as_tensor(rng.normal(size=(cs.H, cs.W)),
                             dtype=torch.float32, device=dev)

    def times(backend):
        (kf, kb), _, k_fwd, k_bwd, _ = cs.backend_paths(backend, packed,
                                                        cs.H, cs.W)
        _, tfin, lc = k_fwd()
        gtu = (g_tfin * tfin).contiguous()
        return (f"{kf} {cs.graph_ms(k_fwd, 20):.4f} {kb} "
                f"{cs.graph_ms(lambda: k_bwd(g_acc, gtu, tfin, lc), 20):.4f}")

    sized = cs.sized_backends(packed, cs.H, cs.W)
    for _ in range(2):
        for name, lib in libs.items():
            # the wrappers launch whatever library is loaded for the source
            cuda_build._loaded[SOURCE] = lib
            print(f"{name}: " + " ".join(times(b) for b in sized.values()),
                  flush=True)
    print("dense, for scale: " + times("pallas"))


if __name__ == "__main__":
    main()
