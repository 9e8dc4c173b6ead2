"""Sharded renders and the sharded training step on torch.distributed (port
of instantsplat_tpu/parallel/sharding.py).

Layouts, as in the JAX package:
- pixels (`sharded_render`): the image is cut into contiguous row blocks
  of ceil(H / ndev) rows, one per rank (the last padded, the image cut
  back to H rows); every rank composites its rows against the whole
  depth-sorted splat array, shifted by -y0;
- gaussians (`gaussian_sharded_render`): each rank composites a
  contiguous depth slice of the sorted array over the whole image, and
  the slices merge with the over operator;
- both (`hybrid_sharded_render`): row blocks over one axis of a 2-D mesh,
  depth slices over the other.

Each render is a per-rank local function of (rank, world) that calls the
kernel (`rows_local`, `slice_local`, `tile_local`), the collective that
joins the ranks (`_gather`), and the join itself (`join_rows`,
`merge_depth_slices`), which is plain tensor code: `chip_smoke.py` runs
every rank's local part on one card and joins them with the same code.

Gradients. Every rank computes the same loss on the joined image, so the
adjoint of the gather is this rank's own slice of the image's cotangent
(no communication), and each rank's backward yields its part of the
parameter gradients: the front end's backward is linear in the splat
cotangent, so the parts sum to the one-device gradient. The parameters
enter each render through `_SumGradients`, an identity whose backward
all-reduces their gradients in one flat buffer: every rank then holds the
same summed gradient bit for bit (an all-reduce returns one result to
every rank), and identical Adam steps keep the replicated parameters
identical. The JAX package psums the [N, 16] splat cotangent instead and
runs the front end's backward on every chip; here that backward runs on
atomics on the card, whose sums are not reproducible bit for bit, so the
ranks' "replicated" parameters could drift apart.

Host-side decisions are shared: under a capacity backend the overflow
guard reads every rank's overflow flag, all-reduced with MAX, so all
ranks demote together (inside a block of steps the flag is recorded on
the device and read at the block's end, render/driver.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from instantsplat_tpu_torch.ops import rasterize_pallas
from instantsplat_tpu_torch.ops.rasterize import composite_out, composite_plain
from instantsplat_tpu_torch.ops.rasterize_lists import composite_lists
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as binned
from instantsplat_tpu_torch.parallel.runtime import (
    all_gather_cat,
    all_reduce_flat,
    make_mesh_nd,
    world_size,
)
from instantsplat_tpu_torch.parallel.runtime import axis as mesh_axis
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import prepare_packed_splats

AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = AXIS):
    """1-D mesh over the first n_devices ranks (default: all)."""
    return make_mesh_nd((world_size() if n_devices is None else n_devices,),
                        (axis_name,))


def _padded_rows(height: int, ndev: int) -> int:
    """Rows per block: ceil(height / ndev)."""
    return -(-height // ndev)


# ---- collectives with the adjoints of a replicated loss ---------------------


class _Gather(torch.autograd.Function):
    """[world, *x.shape]: every rank's x, stacked in rank order. The
    adjoint is this rank's slice of the output's cotangent: right when
    every rank computes the same function of the gathered value."""

    @staticmethod
    def forward(ctx, x, group, index: int):
        ctx.index = index
        return all_gather_cat(x[None], group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


def _gather(x, group, index: int):
    return _Gather.apply(x, group, index)


class _SumGradients(torch.autograd.Function):
    """Identity on the parameters; the backward sums their gradients over
    `groups` (all-reduced over each in turn) in one flat buffer."""

    @staticmethod
    def forward(ctx, groups, *tensors):
        ctx.groups = groups
        ctx.shapes = [t.shape for t in tensors]
        ctx.device = tensors[0].device
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, device=ctx.device) if g is None else g
                 for g, s in zip(grads, ctx.shapes)]
        return (None, *all_reduce_flat(grads, ctx.groups))


def _mesh_groups(mesh):
    return [mesh.get_group(name) for name in mesh.mesh_dim_names]


def replicated_inputs(gaussians, pose, mesh):
    """(gaussians, pose) routed through _SumGradients over every axis of
    `mesh`: the gradients that reach them are the whole loss's, on every
    rank. Tensors that do not require a gradient pass through."""
    fields = [f.name for f in dataclasses.fields(gaussians)
              if torch.is_tensor(getattr(gaussians, f.name))
              and getattr(gaussians, f.name).requires_grad]
    tensors = [getattr(gaussians, f) for f in fields]
    with_pose = pose.requires_grad
    if with_pose:
        tensors.append(pose)
    if not tensors or not torch.is_grad_enabled():
        return gaussians, pose
    out = _SumGradients.apply(_mesh_groups(mesh), *tensors)
    if with_pose:
        pose = out[-1]
    return dataclasses.replace(gaussians, **dict(zip(fields, out))), pose


# ---- per-rank local parts ---------------------------------------------------


def _shift_rows(packed, y0: float):
    """packed with every splat's row centre moved by -y0: block-local row
    coordinates."""
    if y0 == 0:
        return packed
    shift = torch.zeros(packed.shape[1], device=packed.device)
    shift[1] = y0
    return packed - shift


def rows_local(packed, rank: int, world: int, height: int, width: int,
               backend: str = "pallas", chunk: int = 256):
    """This rank's row block of the image: (acc [4, rows, W], tfin [rows,
    W]) for the rows [rank * rows, (rank + 1) * rows), rows =
    ceil(height / world). backend "pallas": KR/K1/K2 on the splats shifted
    by -y0; "pallas-binned[:CF:DL]" (or any other capacity string, as the
    JAX package reads it): K3/K4 over the block's own band lists; "oracle":
    the plain compositor at a row offset. On a CPU tensor every kernel
    backend runs its plain version."""
    rows = _padded_rows(height, world)
    y0 = float(rank * rows)
    if backend == "oracle":
        acc, tfin, _ = composite_plain(packed, rows, width, chunk=chunk,
                                       y_offset=y0)
        return acc, tfin
    local = _shift_rows(packed, y0)
    if backend == "pallas":
        return rasterize_pallas.composite_packed(local, rows, width)
    cf, dl = driver._parse_binned_caps(backend)
    lists, geom = binned.bin_lists(local, rows, width, cf, dl)
    return composite_lists(local, lists, geom, rows, width, binned.K3,
                           binned.K4)


def pad_slices(packed, world: int):
    """packed padded at the back of the depth order to a multiple of
    `world` rows with invalid splats (log-opacity -inf)."""
    n = packed.shape[0]
    n_pad = -(-n // world) * world
    if n_pad == n:
        return packed
    pad = torch.zeros((n_pad - n, packed.shape[1]), device=packed.device,
                      dtype=packed.dtype)
    pad[:, 5] = -torch.inf
    return torch.cat([packed, pad])


def slice_local(packed, rank: int, world: int, height: int, width: int):
    """(acc [4, H, W], tfin [H, W]) of this rank's contiguous depth slice
    of a `pad_slices`-padded array, composited with no background
    (KR/K1/K2 on the card)."""
    per = packed.shape[0] // world
    return rasterize_pallas.composite_packed(
        packed[rank * per:(rank + 1) * per], height, width)


def tile_local(packed, pix_rank: int, n_pix: int, gauss_rank: int,
               n_gauss: int, height: int, width: int):
    """(acc, tfin) of one (row block, depth slice) tile of a padded array:
    the hybrid render's local part."""
    per = packed.shape[0] // n_gauss
    rows = _padded_rows(height, n_pix)
    local = _shift_rows(packed[gauss_rank * per:(gauss_rank + 1) * per],
                        float(pix_rank * rows))
    return rasterize_pallas.composite_packed(local, rows, width)


# ---- joins ------------------------------------------------------------------


def join_rows(accs, tfins, height: int):
    """Row blocks [world, 4, rows, W] / [world, rows, W] -> the image's
    (acc [4, H, W], tfin [H, W]), the padding rows cut off."""
    world, c, rows, w = accs.shape
    acc = accs.permute(1, 0, 2, 3).reshape(c, world * rows, w)[:, :height]
    return acc, tfins.reshape(world * rows, w)[:height]


def merge_depth_slices(accs, tfins, bg):
    """Over-operator merge of depth-ordered slices: accs [S, 4, h, w]
    premultiplied colour and depth, tfins [S, h, w] transmittances ->
    (rgb [h, w, 3], alpha [h, w], depth [h, w]). Slice i is weighted by
    the product of every earlier slice's transmittance:
    (C_a, T_a) o (C_b, T_b) = (C_a + T_a C_b, T_a T_b)."""
    # running products by multiplication: the backwards of cumprod and
    # prod read on the host whether an input is zero, which a captured
    # step cannot do
    prefix = [torch.ones_like(tfins[0])]
    for t in tfins:
        prefix.append(prefix[-1] * t)
    total = prefix.pop()
    prefix = torch.stack(prefix)
    acc = (prefix[:, None] * accs).sum(0)
    rgb = acc[:3].permute(1, 2, 0) + total[..., None] * bg
    return rgb, 1.0 - total, acc[3]


# ---- renders ----------------------------------------------------------------


def _defaults(gaussians, camera, pose, bg, active_sh_degree):
    if pose is None:
        pose = camera.pose
    if bg is None:
        bg = torch.zeros(3, device=pose.device)
    if active_sh_degree is None:
        active_sh_degree = gaussians.max_sh_degree
    return pose, bg, active_sh_degree


def _packed(gaussians, camera, pose, active_sh_degree, scale_modifier):
    packed, _ = prepare_packed_splats(
        gaussians, pose, camera.fx, camera.fy, camera.cx, camera.cy,
        scale_modifier, active_sh_degree, camera.height, camera.width)
    return packed


def _shared_backend(packed, backend: str, rows: int, width: int, group):
    """The per-block capacity backend, or "pallas" once any rank's block
    lists overflow: the driver's overflow guard, reading the flag
    all-reduced with MAX so every rank takes the same decision."""
    if backend in ("oracle", "pallas"):
        return backend
    cf, dl = driver._parse_binned_caps(backend)
    key = ("sharded", int(packed.shape[0]), rows, width, cf, dl)

    def overflow():
        """Any rank's block lists overflow: a device flag."""
        p = packed.detach()
        flag = binned.bin_overflow(p[:, :2], p[:, 2:5], p[:, 5],
                                   driver.splat_valid(p), rows, width, cf,
                                   dl).to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return flag[0] > 0

    def warn():
        driver._log.warning(
            "sharded binned rasterizer: a row block's lists overflow for "
            "N=%d %dx%d; this signature runs the dense kernels on every "
            "rank from now on", key[1], rows, width)

    # inside a block of steps the guard records the flag on the device and
    # reads it at the block's end
    return "pallas" if driver._guard.check(key, overflow, warn) else backend


def sharded_render(gaussians, camera, mesh, pose=None, bg=None,
                   active_sh_degree: Optional[int] = None, chunk: int = 256,
                   scale_modifier: float = 1.0, backend: str = "oracle"):
    """Render one view with pixel rows sharded over the mesh's "data" axis.

    Returns (rgb [H,W,3], alpha [H,W], depth [H,W]), the same on every
    rank. Differentiable w.r.t. the Gaussians and the pose: the gradients
    are the whole image's on every rank. `backend` is each rank's local
    compositor: "oracle", "pallas" (KR/K1/K2) or "pallas-binned[:CF:DL]"
    (K3/K4)."""
    pose, bg, active_sh_degree = _defaults(gaussians, camera, pose, bg,
                                           active_sh_degree)
    group, rank, ndev = mesh_axis(mesh, AXIS)
    h, w = camera.height, camera.width
    gaussians, pose = replicated_inputs(gaussians, pose, mesh)
    packed = _packed(gaussians, camera, pose, active_sh_degree,
                     scale_modifier)
    backend = _shared_backend(packed, backend, _padded_rows(h, ndev), w,
                              group)
    acc, tfin = rows_local(packed, rank, ndev, h, w, backend, chunk)
    acc, tfin = join_rows(_gather(acc, group, rank),
                          _gather(tfin, group, rank), h)
    out = composite_out(acc, tfin, bg)
    return out.rgb, out.alpha, out.depth


def gaussian_sharded_render(gaussians, camera, mesh, pose=None, bg=None,
                            active_sh_degree: Optional[int] = None,
                            scale_modifier: float = 1.0):
    """Render one view with the Gaussians depth-sliced over the mesh's
    "data" axis: each rank composites a contiguous slice of the globally
    sorted splats over the whole image (KR/K1/K2), and the slices merge
    with the over operator. The front end and the global sort stay
    replicated, so this scales compositing work, not memory.

    As in the JAX package, the latched stop (T < 1e-4) cannot see across
    slices: a later slice still composites splats the one-device latch
    would drop, weighted by the true incident transmittance. This is
    JAX's sharded result, not the one-device one; the difference is
    bounded by the incident T at the latch (<= ~1e-2 with one ALPHA_MAX
    splat).

    Returns (rgb, alpha, depth), the same on every rank."""
    pose, bg, active_sh_degree = _defaults(gaussians, camera, pose, bg,
                                           active_sh_degree)
    group, rank, ndev = mesh_axis(mesh, AXIS)
    h, w = camera.height, camera.width
    gaussians, pose = replicated_inputs(gaussians, pose, mesh)
    packed = pad_slices(_packed(gaussians, camera, pose, active_sh_degree,
                                scale_modifier), ndev)
    acc, tfin = slice_local(packed, rank, ndev, h, w)
    return merge_depth_slices(_gather(acc, group, rank),
                              _gather(tfin, group, rank), bg)


def hybrid_sharded_render(gaussians, camera, mesh, pose=None, bg=None,
                          active_sh_degree: Optional[int] = None,
                          scale_modifier: float = 1.0, pix_axis: str = "pix",
                          gauss_axis: str = "gauss"):
    """Render with both axes of a 2-D mesh: row blocks over `pix_axis`,
    depth slices over `gauss_axis`. Each rank composites its (slice, rows)
    tile; the merge runs along `gauss_axis`, then the merged row blocks
    gather along `pix_axis`. Same latch semantics as
    `gaussian_sharded_render`. Returns (rgb, alpha, depth)."""
    pose, bg, active_sh_degree = _defaults(gaussians, camera, pose, bg,
                                           active_sh_degree)
    gp, pi, n_pix = mesh_axis(mesh, pix_axis)
    gg, gi, n_gauss = mesh_axis(mesh, gauss_axis)
    h, w = camera.height, camera.width
    gaussians, pose = replicated_inputs(gaussians, pose, mesh)
    packed = pad_slices(_packed(gaussians, camera, pose, active_sh_degree,
                                scale_modifier), n_gauss)
    acc, tfin = tile_local(packed, pi, n_pix, gi, n_gauss, h, w)
    rgb, alpha, depth = merge_depth_slices(_gather(acc, gg, gi),
                                           _gather(tfin, gg, gi), bg)
    block = torch.cat([rgb, alpha[..., None], depth[..., None]], -1)
    blocks = _gather(block, gp, pi)  # [n_pix, rows, W, 5]
    img = blocks.reshape(-1, w, 5)[:h]
    return img[..., :3], img[..., 3], img[..., 4]


def make_sharded_train_step(optimizer, cameras, bg, lambda_dssim: float,
                            mesh, chunk: int = 256, backend: str = "oracle",
                            shard_axis: str = "pixels"):
    """Sharded version of pipelines.trainer.train_step: -> step(params,
    opt_state, view_idx, iteration, active_sh) -> metrics, updating params
    and opt_state in place. Render sharded over `mesh` (`shard_axis`:
    "pixels" or "gaussians"), loss, backward (gradients summed over the
    ranks), grouped Adam on every rank."""
    from instantsplat_tpu_torch.pipelines.trainer import train_step

    assert shard_axis in ("pixels", "gaussians"), shard_axis

    def step(params, opt_state, view_idx: int, iteration: int,
             active_sh: int):
        return train_step(params, cameras[view_idx], optimizer, opt_state,
                          iteration, active_sh, bg, lambda_dssim, backend,
                          chunk, mesh=mesh, shard_axis=shard_axis)

    return step
