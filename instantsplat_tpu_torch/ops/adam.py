"""Stage 2's Adam step on CUDA tensors (csrc/adam.cu).

`GaussianOptimizer.apply_step` calls `fused_step` where `serves` holds
(the parameters are CUDA tensors) and its plain version, `apply_step_plain`,
elsewhere. A step is two launches over all seven groups of PARAM_FIELDS:
with pp_optimizer, adam_flags decides each group's whole-tensor
zero-gradient skip on the device; adam_update then reads each parameter,
gradient and moment once and writes each once (a skipped group's moments
neither read nor written back), with the plain version's bits (the
source's header note says how it rounds). The step reads its factors from
its row of `step_scalars` on the device, so it can be captured, and adds
one to a group's entry of the device's skip table (`skip_table`) for each
step in which that group's skip held.
"""

from __future__ import annotations

import ctypes

import torch

from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
from instantsplat_tpu_torch.ops.cuda_build import Kernel

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the groups both kernels take: their count, element counts, and the
# parameter, gradient, first and second moment pointers
_GROUPS = [_I, ctypes.POINTER(ctypes.c_longlong)] + [
    ctypes.POINTER(ctypes.c_void_p)] * 4
ADAM_FLAGS = Kernel("adam_flags", _GROUPS + [_P, _P], source="adam.cu")
ADAM_UPDATE = Kernel("adam_update",
                     _GROUPS + [_P, _P, _I] + [_F] * 5 + [_P, _P, _P],
                     source="adam.cu")


_SKIPPED: dict = {}  # device -> its skip table, never replaced


def skip_table(device) -> torch.Tensor:
    """[len(PARAM_FIELDS)] int32 on `device`: for each group, the fused
    steps on that device in which its whole-tensor zero-gradient skip held.
    One a device for the process, made by the first call there and never
    replaced, so a captured step's pointer to it stays live; the first call
    has to come outside a capture (a warm-up step, as StepLoop takes)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    table = _SKIPPED.get(device)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"adam: the skip table of {device} would be made inside a "
                "CUDA graph capture; take one step on the device first")
        table = _SKIPPED[device] = torch.zeros(
            len(PARAM_FIELDS), dtype=torch.int32, device=device)
    return table


def serves(t: torch.Tensor) -> bool:
    """Whether parameters on t's device take the fused step."""
    return t.is_cuda


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _group(params, grads, state, name: str):
    p, g = getattr(params, name), grads[name]
    m, v = state.m[name], state.v[name]
    for what, x in (("parameter", p), ("gradient", g), ("first moment", m),
                    ("second moment", v)):
        if (x.dtype != torch.float32 or x.device != p.device
                or x.shape != p.shape):
            raise ValueError(f"adam: the {what} of {name} is {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}, not "
                             f"torch.float32 {tuple(p.shape)} on {p.device}")
        if x is not g and not x.is_contiguous():
            raise ValueError(f"adam: the {what} of {name} is not contiguous "
                             "(it is updated in place)")
    return p, g.contiguous(), m, v


@torch.no_grad()
def fused_step(cfg, params, grads: dict, state,
               scalars: torch.Tensor) -> None:
    """GaussianOptimizer.apply_step on the device: params and state's
    moments in place, and with pp_optimizer the device's skip table.
    cfg: the OptimizationConfig; scalars: the step's row of step_scalars
    ([len(PARAM_FIELDS) + 1] float32 on the device)."""
    groups = [_group(params, grads, state, name) for name in PARAM_FIELDS]
    dev = params.xyz.device
    if (scalars.dtype != torch.float32 or scalars.device != dev
            or scalars.numel() != len(PARAM_FIELDS) + 1):
        raise ValueError(f"adam: the step's scalars are {scalars.dtype} "
                         f"{tuple(scalars.shape)} on {scalars.device}, not "
                         f"torch.float32 ({len(PARAM_FIELDS) + 1},) on {dev}")
    scalars = scalars.contiguous()
    ppl = state.per_point_lr if cfg.pp_optimizer else None
    if ppl is not None:
        if (ppl.dtype != torch.float32 or ppl.device != dev
                or ppl.numel() != params.xyz.shape[0]):
            raise ValueError(f"adam: the per-point rates are {ppl.dtype} "
                             f"{tuple(ppl.shape)} on {ppl.device}, not "
                             f"torch.float32 ({params.xyz.shape[0]}, 1) on "
                             f"{dev}")
        ppl = ppl.contiguous()
    arrays = (
        (ctypes.c_longlong * len(groups))(*(p.numel() for p, *_ in groups)),
        *((ctypes.c_void_p * len(groups))(*(x[k].data_ptr() for x in groups))
          for k in range(4)))
    flags = (torch.empty(2 * len(groups), dtype=torch.int32, device=dev)
             if cfg.pp_optimizer else None)
    skipped = skip_table(dev)
    with torch.cuda.device(dev):
        if flags is not None:
            ADAM_FLAGS(len(groups), *arrays, flags.data_ptr(), _stream())
        ADAM_UPDATE(len(groups), *arrays,
                    None if ppl is None else ppl.data_ptr(),
                    scalars.data_ptr(), int(cfg.pp_optimizer), cfg.beta1,
                    1 - cfg.beta1, cfg.beta2, 1 - cfg.beta2, cfg.eps,
                    None if flags is None else flags.data_ptr(),
                    skipped.data_ptr(), _stream())
