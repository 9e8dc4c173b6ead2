"""Carry weights and optimiser state between the JAX and PyTorch packages
as numpy arrays.

`gaussians_from_numpy` / `adam_state_from_numpy` take the fields of the JAX
`GaussianModel` / `AdamState` (passed as numpy arrays, e.g.
`{f: np.asarray(getattr(g, f)) for f in PARAM_FIELDS}`) and build the
port's tensors; `to_numpy` goes back. `lpips_from_numpy` builds the port's
LPIPS network from the JAX `LpipsVGG` arrays. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.eval.image_metrics import LpipsVGG
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import AdamState


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def gaussians_from_numpy(arrays: dict, max_sh_degree: int,
                         device="cuda") -> GaussianModel:
    """arrays: field name -> array for every field in PARAM_FIELDS."""
    return GaussianModel(**{f: _t(arrays[f], device) for f in PARAM_FIELDS},
                         max_sh_degree=int(max_sh_degree))


def adam_state_from_numpy(m: dict, v: dict, step: int,
                          per_point_lr: Optional[np.ndarray] = None,
                          device="cuda") -> AdamState:
    """m, v: field name -> moment array; step: Adam steps taken."""
    return AdamState(
        m={f: _t(m[f], device) for f in PARAM_FIELDS},
        v={f: _t(v[f], device) for f in PARAM_FIELDS},
        step=int(step),
        per_point_lr=(None if per_point_lr is None
                      else _t(per_point_lr, device)),
    )


def lpips_from_numpy(conv_w, conv_b, lin_w, device="cuda") -> LpipsVGG:
    """The JAX LpipsVGG's conv_w (HWIO), conv_b and lin_w (HWIO) arrays ->
    the port's network (OIHW)."""
    def oihw(ws):
        return [np.asarray(w).transpose(3, 2, 0, 1) for w in ws]

    return LpipsVGG.from_arrays(oihw(conv_w), conv_b, oihw(lin_w),
                                device=device)


def to_numpy(obj) -> dict:
    """GaussianModel -> {field: array, "max_sh_degree": int};
    AdamState -> {"m": {...}, "v": {...}, "step": int, "per_point_lr": ...}."""
    def a(t):
        return t.detach().cpu().numpy()

    if isinstance(obj, GaussianModel):
        out = {f: a(getattr(obj, f)) for f in PARAM_FIELDS}
        out["max_sh_degree"] = obj.max_sh_degree
        return out
    if isinstance(obj, AdamState):
        return {"m": {f: a(obj.m[f]) for f in PARAM_FIELDS},
                "v": {f: a(obj.v[f]) for f in PARAM_FIELDS},
                "step": obj.step,
                "per_point_lr": (None if obj.per_point_lr is None
                                 else a(obj.per_point_lr))}
    raise TypeError(f"cannot convert {type(obj).__name__}")
