"""instantsplat_tpu_torch — the PyTorch + CUDA port of instantsplat_tpu.

The JAX package `instantsplat_tpu` stays the reference; this package mirrors
its module names so each ported function can be found beside its
counterpart. Plain tensor code is PyTorch; every Pallas kernel of the JAX
package is hand-written CUDA for Hopper: the dense compositor
(`csrc/rasterize.cu`, bound with ctypes in `ops/rasterize_pallas.py`) and
the binned and tiled list compositors (`csrc/rasterize_lists.cu`,
`ops/rasterize_lists.py`). One kernel has no Pallas counterpart: the
initial scales' KNN (`csrc/knn.cu`, `ops/knn.py`), which the JAX package
leaves to plain jnp, written by hand because the plain chunked search
took most of a large stage-2 scene on the H100.

Ported so far: stage 1 (`cli.init_geo`: MASt3R pair inference, the
global aligner, the `sparse_{n}` writer), stage 2 (`cli.train`, the joint
Gaussian + camera-pose optimisation, with every rasterizer backend and
the `auto` probe, the validation sweep and the live viewer), stage 3
(`cli.render`, or `cli.init_test_pose`), stage 5 (`cli.metrics`), the
orchestration (`cli.run_eval`, `cli.run_infer`), `cli.demo`, and the
MASt3R sparse-alignment toolset (`ops/matching`, `init/sparse_align`,
`init/depth_refine`, `models/densify`, `data/colmap_db`, `data/exr` with
its host C++ codec `csrc/exr_native.cpp`, the Blender reader), MASt3R
pre-training (`train_dust3r/`, `cli.pretrain`) and the multi-device layer
(`parallel/`, on torch.distributed: one process per card).

Entry points take an explicit `device` and default to "cuda". Asking for
CUDA without a card raises; nothing falls back to the CPU.

float32 means float32: importing the package switches TF32 off for cuBLAS
matmuls and cuDNN convolutions (PyTorch enables it for cuDNN by default),
so the card computes what the CPU and the JAX package compute.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
