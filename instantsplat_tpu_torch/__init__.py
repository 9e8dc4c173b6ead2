"""instantsplat_tpu_torch — the PyTorch + CUDA port of instantsplat_tpu.

The JAX package `instantsplat_tpu` stays the reference; this package mirrors
its module names so each ported function can be found beside its
counterpart. Plain tensor code is PyTorch; every Pallas kernel of the JAX
package is hand-written CUDA for Hopper: the dense compositor
(`csrc/rasterize.cu`, bound with ctypes in `ops/rasterize_pallas.py`) and
the binned and tiled list compositors (`csrc/rasterize_lists.cu`,
`ops/rasterize_lists.py`).

Ported so far: stage 2, the joint Gaussian + camera-pose optimisation
(`cli.train` -> `pipelines.train_pipeline.run_training` ->
`pipelines.trainer.train_joint`), with every rasterizer backend and the
`auto` probe.

Entry points take an explicit `device` and default to "cuda". Asking for
CUDA without a card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
