"""Densification and pruning for adaptive Gaussian control (port of
instantsplat_tpu/models/densify.py; reference scene/gaussian_model.py).

- `densify_and_clone`: duplicate Gaussians with large view-space
  positional gradients and small world scale;
- `densify_and_split`: replace large high-gradient Gaussians with
  `n_split` samples drawn from their own distribution, scales / (0.8 n);
- `prune_points`: drop by minimum opacity, screen radius and world size;
- `reset_opacity`: opacity <- min(opacity, 0.01);
- `accumulate_grad_stats`: the running sum of view-space gradient norms.

Each returns a new (GaussianModel, AdamState) with a new N: the moments of
surviving points are kept, new points start with zero moments and a
per-point learning rate of 1. The camera poses (and their moments) are
never touched. The split's normals come from a `torch.Generator` seeded
with `seed` on the parameters' device; `_split` takes them as an argument,
so a test can hand it JAX's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from instantsplat_tpu_torch.models.gaussians import (GaussianModel,
                                                      inverse_sigmoid)
from instantsplat_tpu_torch.opt.gaussian_opt import AdamState
from instantsplat_tpu_torch.utils import transforms as T

POINT_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")


def _scale(params: GaussianModel) -> torch.Tensor:
    return torch.exp(params.scaling)


def _select(params: GaussianModel, state: AdamState, idx):
    """Gather point rows of params and moments (cam_poses untouched)."""
    m, v = dict(state.m), dict(state.v)
    for f in POINT_FIELDS:
        m[f], v[f] = m[f][idx], v[f][idx]
    ppl = state.per_point_lr
    return (
        dataclasses.replace(params, **{f: getattr(params, f)[idx]
                                       for f in POINT_FIELDS}),
        AdamState(m=m, v=v, step=state.step,
                  per_point_lr=None if ppl is None else ppl[idx]),
    )


def _concat(params: GaussianModel, state: AdamState, new_points: dict):
    """Append new points with zero moments and a per-point lr of 1."""
    m, v, new_p = dict(state.m), dict(state.v), {}
    for f in POINT_FIELDS:
        add = new_points[f]
        new_p[f] = torch.cat([getattr(params, f), add], 0)
        m[f] = torch.cat([m[f], torch.zeros_like(add)], 0)
        v[f] = torch.cat([v[f], torch.zeros_like(add)], 0)
    ppl = state.per_point_lr
    if ppl is not None:
        ppl = torch.cat([ppl, ppl.new_ones((len(new_points["xyz"]), 1))], 0)
    return (dataclasses.replace(params, **new_p),
            AdamState(m=m, v=v, step=state.step, per_point_lr=ppl))


def accumulate_grad_stats(xyz_gradient_accum, denom, mean2d_grad, visible):
    """Running sums of view-space positional gradient norms and of
    visibility (gaussian_model.py:337-341 add_densification_stats)."""
    gnorm = torch.sqrt(torch.sum(mean2d_grad * mean2d_grad, -1))
    xyz_gradient_accum = xyz_gradient_accum + torch.where(
        visible, gnorm, torch.zeros_like(gnorm))
    return xyz_gradient_accum, denom + visible.float()


def densify_and_clone(params, state, grads_mean, grad_threshold, extent,
                      percent_dense=0.01):
    """Duplicate small high-gradient Gaussians (gaussian_model.py:416-428)."""
    scale_max = torch.amax(_scale(params), dim=-1)
    mask = (grads_mean >= grad_threshold) & (
        scale_max <= percent_dense * extent)
    if not bool(mask.any()):
        return params, state
    idx = torch.nonzero(mask)[:, 0]
    return _concat(params, state,
                   {f: getattr(params, f)[idx] for f in POINT_FIELDS})


def _split(params, state, idx, normals, n_split):
    """The split of points `idx` given normals [n_split, K, 3]."""
    stds = _scale(params)[idx]  # [K, 3]
    rots = T.quat_to_rotmat(T.quat_normalize(params.rotation[idx]))
    samples = normals * stds[None]
    new_xyz = (torch.einsum("kij,nkj->nki", rots, samples)
               + params.xyz[idx][None]).reshape(-1, 3)

    def rep(x):
        return x[idx].repeat(n_split, *([1] * (x.ndim - 1)))

    new = {
        "xyz": new_xyz,
        "features_dc": rep(params.features_dc),
        "features_rest": rep(params.features_rest),
        "scaling": torch.log(stds.repeat(n_split, 1) / (0.8 * n_split)),
        "rotation": rep(params.rotation),
        "opacity": rep(params.opacity),
    }
    params, state = _concat(params, state, new)
    # prune the originals (keep everything else and the new samples)
    keep = torch.ones(params.num_points, dtype=torch.bool,
                      device=params.xyz.device)
    keep[idx] = False
    return _select(params, state, torch.nonzero(keep)[:, 0])


def densify_and_split(params, state, grads_mean, grad_threshold, extent,
                      percent_dense=0.01, n_split=2, seed=0):
    """Split large high-gradient Gaussians into `n_split` samples drawn
    from their own covariance, scales / (0.8 n_split), originals pruned
    (gaussian_model.py:391-414)."""
    scale_max = torch.amax(_scale(params), dim=-1)
    mask = (grads_mean >= grad_threshold) & (
        scale_max > percent_dense * extent)
    if not bool(mask.any()):
        return params, state
    idx = torch.nonzero(mask)[:, 0]
    dev = params.xyz.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    normals = torch.randn((n_split, len(idx), 3), generator=gen, device=dev)
    return _split(params, state, idx, normals, n_split)


def prune_points(params, state, min_opacity=0.005, extent=None,
                 max_screen_size=None, radii=None):
    """Drop low-opacity (and, with `max_screen_size` and `radii`,
    oversized) Gaussians (gaussian_model.py:460-474)."""
    prune = torch.sigmoid(params.opacity)[:, 0] < min_opacity
    if max_screen_size is not None and radii is not None:
        prune |= torch.as_tensor(radii, device=prune.device) > max_screen_size
        prune |= torch.amax(_scale(params), -1) > 0.1 * extent
    keep = torch.nonzero(~prune)[:, 0]
    if len(keep) == params.num_points:
        return params, state
    return _select(params, state, keep)


def reset_opacity(params: GaussianModel) -> GaussianModel:
    """opacity <- inverse_sigmoid(min(opacity, 0.01))
    (gaussian_model.py:279-283)."""
    return dataclasses.replace(params, opacity=inverse_sigmoid(
        torch.clamp_max(torch.sigmoid(params.opacity), 0.01)))
