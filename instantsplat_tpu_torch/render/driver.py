"""Pose-differentiable render driver (port of instantsplat_tpu/render/driver.py).

The pose is an ordinary tensor input: autograd carries its gradient
through the front-end's world-to-camera transform. Backends:

- "oracle": the plain PyTorch compositor (ops/rasterize.py);
- "auto" and "pallas" (the names kept so the JAX CLI flags still parse):
  the dense kernels K1/K2 on a CUDA tensor, their plain version on a CPU
  tensor (ops/rasterize_pallas.py). A single render resolves "auto" to the
  dense kernels; the training loop's probe (pipelines/trainer.py) is where
  auto picks between dense and a capacity backend;
- "pallas-binned[:CF:DL]": the 1-D binned kernels K3/K4
  (ops/rasterize_pallas_binned.py);
- "pallas-tiled[:CF:DY:DX]": the 2-D tiled kernels K5/K6
  (ops/rasterize_pallas_tiled.py).

The backend string is this module's alone: it parses, sizes
(`capacity_candidate`, backend="auto"'s candidate) and guards it, and its
callers ask it for a name's `family`, whether it `is_capacity` and the
`graph_key` a captured loop is kept under.

Every call of a capacity backend builds its lists once and hands their
overflow flag to one rate-limited guard: on the first call for a
signature (N, H, W, capacities) and every _BINNED_CHECK_EVERY calls after,
the flag is read; an overflowing signature is demoted to the dense kernels
for good, with a warning, since the dense kernels never drop a splat.
Inside a block of steps that runs from a captured CUDA graph (the loops
that render bracket their StepLoop runs with `recording_overflow`),
nothing is read: every call ORs its flag into a device tensor, read once
at the block's end. The sharded render's row blocks go through the same
guard, their flag all-reduced (`row_block_lists`). Each demotion counts
in the counter `render.demotions` (utils/profiling.py). Inside a traced
loop step the render marks the end of the front end's columns
("frontend") and, in the backward, the gradient reaching the packed
splats ("raster_bwd").
"""

from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple, Optional

import torch

from instantsplat_tpu_torch.ops import (
    rasterize,
    rasterize_pallas,
    rasterize_pallas_binned,
    rasterize_pallas_tiled,
)
from instantsplat_tpu_torch.ops.frontend import compute_columns, frontend_rows
from instantsplat_tpu_torch.ops.rasterize import composite_out
from instantsplat_tpu_torch.ops.rasterize_lists import (composite_lists,
                                                        splat_valid)
from instantsplat_tpu_torch.utils import profiling

# Finite "invalid" depth sentinel: sorts after every real depth, and a zero
# compositing weight times it stays zero (inf would give 0 * inf = NaN).
_INVALID_DEPTH = 1e30


class RenderOut(NamedTuple):
    render: torch.Tensor  # [H, W, 3]
    alpha: torch.Tensor  # [H, W]
    depth: torch.Tensor  # [H, W]
    radii: torch.Tensor  # [N] screen-space 3-sigma radii (0 = culled)
    visibility: torch.Tensor  # [N] bool, radii > 0


def prepare_packed_splats(gaussians, pose, fx, fy, cx, cy, scale_modifier,
                          active_sh_degree: int, height: int, width: int):
    """Front-end + depth sort -> (packed [N, 10] sorted front to back, the
    unsorted FrontendCols). Columns: mx, my, conic a b c, log-opacity (-inf
    for invalid rows), r, g, b, depth; column 9 is the sorted key itself,
    so invalid rows carry the finite sentinel. The sort is stable, so the
    order is deterministic; tied invalid rows contribute nothing.
    On CUDA tensors the front end is the kernels' (ops/frontend.py::
    frontend_rows: the rows come out packed, with the sentinels; the
    FrontendCols' log_op and depth carry them too); on CPU tensors it is
    compute_columns'."""
    if gaussians.xyz.is_cuda:
        rows, key, cols = frontend_rows(gaussians, pose, fx, fy, cx, cy,
                                        scale_modifier, active_sh_degree,
                                        height, width)
        profiling.mark("frontend")
        _, perm = torch.sort(key, stable=True)
        return rows[perm], cols
    cols = compute_columns(gaussians, pose, fx, fy, cx, cy, scale_modifier,
                           active_sh_degree, height, width)
    profiling.mark("frontend")
    key = torch.where(cols.valid, cols.depth,
                      torch.full_like(cols.depth, _INVALID_DEPTH))
    lo_m = torch.where(cols.valid, cols.log_op,
                       torch.full_like(cols.log_op, -torch.inf))
    key_sorted, perm = torch.sort(key, stable=True)
    packed = torch.stack([cols.mx, cols.my, cols.ca, cols.cb, cols.cc, lo_m,
                          cols.r, cols.g, cols.b], dim=1)[perm]
    return torch.cat([packed, key_sorted[:, None]], dim=1), cols


def prepare_sorted_splats(gaussians, pose, fx, fy, cx, cy, scale_modifier,
                          active_sh_degree: int, height: int, width: int):
    """The front end and depth sort of `prepare_packed_splats`, as six
    arrays sorted front to back: ((mean2d [N, 2], conic [N, 3],
    log_opacity [N] (-inf on invalid rows), colors [N, 3], depth [N] (the
    sorted key: the finite sentinel on invalid rows), valid [N]), the
    unsorted FrontendCols). Views of the one packed array."""
    packed, cols = prepare_packed_splats(
        gaussians, pose, fx, fy, cx, cy, scale_modifier, active_sh_degree,
        height, width)
    depth = packed[:, 9]
    return (packed[:, 0:2], packed[:, 2:5], packed[:, 5], packed[:, 6:9],
            depth, depth < _INVALID_DEPTH), cols


# ---- the backend string ----------------------------------------------------


def family(backend: str) -> str:
    """The backend's name without its capacities: "pallas-tiled" of
    "pallas-tiled:4:3:2" (the counter `train.iterations.<family>`)."""
    return backend.split(":")[0]


def is_capacity(backend: Optional[str]) -> bool:
    """Whether `backend` names a binned or tiled capacity backend."""
    return bool(backend) and backend.startswith(("pallas-binned",
                                                 "pallas-tiled"))


def _caps(backend: str, n: int) -> tuple:
    """The n capacities of "<family>:C1:...:Cn", or n Nones (the kernels'
    defaults) when the string holds other than n."""
    parts = backend.split(":")
    return tuple(map(int, parts[1:])) if len(parts) == n + 1 else (None,) * n


def _check_backend(backend: str) -> str:
    if backend == "auto":
        return "pallas"
    if not (backend in ("pallas", "oracle") or is_capacity(backend)):
        raise ValueError(f"unknown rasterizer backend: {backend}")
    return backend


# ---- the overflow guard ----------------------------------------------------

_log = logging.getLogger(__name__)
_BINNED_CHECK_EVERY = 100


class _OverflowGuard:
    """Call counts and demoted signatures of the capacity backends; while a
    block of steps runs (recording_overflow), the block's overflow flags
    by signature."""

    def __init__(self):
        self.calls: dict = {}
        self.demoted: set = set()
        self.flags: Optional[dict] = None


_guard = _OverflowGuard()


def reset_overflow_guard():
    """Forget every call count and demotion, as in a new process."""
    global _guard
    _guard = _OverflowGuard()


def demoted() -> frozenset:
    """The capacity signatures demoted to the dense kernels so far."""
    return frozenset(_guard.demoted)


def graph_key(backend: str):
    """What a captured graph of renders on `backend` depends on beside its
    tensors: the demoted signatures for a capacity backend (a demotion
    changes the kernels a step launches), else nothing."""
    return is_capacity(backend) and demoted()


@contextlib.contextmanager
def recording_overflow(flags: dict):
    """A block of steps that renders (a utils/cuda_graphs.StepLoop run):
    inside, every capacity call ORs its lists' overflow flag into
    flags[signature] on the device instead of reading it; at the end the
    flags are read once and each signature whose lists overflowed in any
    call is demoted. `flags` lives as long as the loop's graph, which
    writes into the flags its warm-up made. The JAX package's scan checks
    nothing inside a block; the port checks every call and acts at the
    block's end."""
    for f in flags.values():
        f.zero_()
    old, _guard.flags = _guard.flags, flags
    try:
        yield
    finally:
        _guard.flags = old
    with profiling.annotate("steploop.settle"):
        keys = [k for k in flags if k not in _guard.demoted]
        if keys:
            hit = torch.stack([flags[k] for k in keys]).cpu().tolist()
            for key, overflowed in zip(keys, hit):
                if overflowed:
                    _demote(key)


def _demote(key):
    """Signature `key` runs the dense kernels from now on, with a
    warning."""
    _guard.demoted.add(key)
    profiling.count("render.demotions")
    kind, n, h, w, *caps = key
    if kind == "sharded":
        _log.warning(
            "sharded binned rasterizer: a row block's lists overflow for "
            "N=%d %dx%d; this signature runs the dense kernels on every "
            "rank from now on", n, h, w)
    elif kind == "tiled":
        _log.warning(
            "tiled rasterizer capacity exhausted for N=%d %dx%d "
            "(pairs would be dropped); auto-switching this signature "
            "to the dense pallas backend. To keep tiling, re-probe "
            "tiled_view_requirements (current cf=%s dy=%s dx=%s).",
            n, h, w, *caps)
    else:
        remedy = ("re-probe binned_view_requirements for fresh capacities "
                  "(current cap_factor=%s, d_levels=%s)" % tuple(caps)
                  if caps[0] is not None else
                  "raise rasterize_pallas_binned.CAP_FACTOR / D_LEVELS")
        _log.warning(
            "binned rasterizer bin capacity exhausted for N=%d %dx%d "
            "(pairs would be dropped); auto-switching this signature to "
            "the dense pallas backend. To keep binning, %s.", n, h, w,
            remedy)


# ---- the capacity lists ----------------------------------------------------


def _build(packed, height: int, width: int, caps):
    """Binned lists for two capacities, tiled ones for three."""
    if len(caps) == 2:
        return (*rasterize_pallas_binned.bin_lists(packed, height, width,
                                                   *caps),
                rasterize_pallas_binned.K3, rasterize_pallas_binned.K4)
    return (*rasterize_pallas_tiled.tile_lists(packed, height, width, *caps),
            rasterize_pallas_tiled.K5, rasterize_pallas_tiled.K6)


def _backend_caps(backend: str) -> tuple:
    return _caps(backend, 2 if backend.startswith("pallas-binned") else 3)


def build_lists(packed, height: int, width: int, backend: str):
    """The lists of capacity backend `backend` for a packed, depth-sorted
    [N, 10] array, with no overflow guard: -> (SlotLists, ListGeometry,
    forward kernel, backward kernel)."""
    return _build(packed, height, width, _backend_caps(backend))


def _guarded(kind, packed, height: int, width: int, caps,
             reduce=lambda flag: flag):
    """One capacity call under the signature (kind, N, H, W, *caps): the
    lists built once (not at all once it is demoted) and their overflow
    flag, reduce(flag) over the ranks, handed to the guard. Outside a
    block the flag is read on the signature's first call and every
    _BINNED_CHECK_EVERY-th after; inside one it is ORed into the block's
    flag, made in the block's eager warm-up and written by every replay.
    -> the lists as build_lists gives them, or None: the dense kernels."""
    key = (kind, int(packed.shape[0]), height, width, *caps)
    if key in _guard.demoted:
        return None
    built = _build(packed, height, width, caps)
    if _guard.flags is not None:
        overflow = reduce(built[0].overflow)
        flag = _guard.flags.get(key)
        if flag is not None:
            flag.logical_or_(overflow)
        elif overflow.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"overflow guard: signature {key} first "
                               "seen while a step was being captured")
        else:
            _guard.flags[key] = overflow.clone()
        return built
    n = _guard.calls.get(key, 0)
    _guard.calls[key] = n + 1
    if n % _BINNED_CHECK_EVERY == 0 and bool(reduce(built[0].overflow)):
        _demote(key)
        return None
    return built


def capacity_lists(packed, height: int, width: int, backend: str):
    """A one-device render's call of capacity backend `backend`, through
    the overflow guard (_guarded)."""
    caps = _backend_caps(backend)
    return _guarded("binned" if len(caps) == 2 else "tiled", packed, height,
                    width, caps)


def row_block_lists(packed, rows: int, width: int, backend: str,
                    group=None):
    """A sharded render's row block (parallel/sharding.rows_local): the 1-D
    binned lists of `packed`, shifted to the block, for any capacity
    string (its binned capacities, as the JAX package's sharded render
    reads them), through the overflow guard under the signature
    ("sharded", N, rows, W, *caps). With `group` the flag is all-reduced
    with MAX over it, so every rank demotes together."""

    def any_rank(flag):
        if group is None:
            return flag
        import torch.distributed as dist

        flag = flag.to(torch.int32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return flag[0] > 0

    return _guarded("sharded", packed, rows, width, _caps(backend, 2),
                    any_rank)


# ---- sizing ----------------------------------------------------------------


def _sizing_columns(gaussians, pose, camera, scale_modifier):
    """Sorted splat columns of this view at SH degree 0, without a graph."""
    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            gaussians, pose, camera.fx, camera.fy, camera.cx, camera.cy,
            scale_modifier, 0, camera.height, camera.width)
    return packed[:, :2], packed[:, 2:5], packed[:, 5], splat_valid(packed)


def binned_view_requirements(gaussians, pose, camera,
                             scale_modifier: float = 1.0) -> tuple[int, int]:
    """(cap_factor, d_levels) this view needs for drop-free binning, with
    the drift margin (rasterize_pallas_binned.sizing_margin)."""
    return rasterize_pallas_binned.bin_requirements(
        *_sizing_columns(gaussians, pose, camera, scale_modifier),
        camera.height, camera.width)


def tiled_view_requirements(gaussians, pose, camera,
                            scale_modifier: float = 1.0,
                            ) -> tuple[int, int, int]:
    """(cap_factor, dy_levels, dx_levels) this view needs for a drop-free
    2-D tiled build, with the drift margin
    (rasterize_pallas_tiled.sizing_margin_2d)."""
    return rasterize_pallas_tiled.tile_requirements(
        *_sizing_columns(gaussians, pose, camera, scale_modifier),
        camera.height, camera.width)


# backend='auto' refuses binned/tiled above these capacities (list memory
# and build cost scale with cap_factor * N and with the candidate level
# product; extreme requirements mean the scene is dense-kernel territory)
_MAX_BINNED_CAP_FACTOR = 16
_MAX_BINNED_D_LEVELS = 128
_MAX_TILED_LEVEL_PRODUCT = 64  # dy * dx (the candidate sort is O(N*dy*dx))


def _tiled_candidate(params, camera, pose) -> Optional[str]:
    """'pallas-tiled:CF:DY:DX' sized for the CURRENT scene seen from
    `pose`, or None when out of range (huge splats blow the level product;
    huge images blow the int32 tile*splat key space)."""
    n = int(params.xyz.shape[0])
    if rasterize_pallas_tiled.geometry(camera.height, camera.width).n_seg \
            * (n + 1) >= 2**31:
        return None
    cf, dy, dx = tiled_view_requirements(params, pose, camera)
    if cf > _MAX_BINNED_CAP_FACTOR or dy * dx > _MAX_TILED_LEVEL_PRODUCT:
        return None
    return f"pallas-tiled:{cf}:{dy}:{dx}"


def capacity_candidate(params, camera, pose=None) -> Optional[str]:
    """backend='auto''s capacity backend: the string whose capacities hold
    every splat of the CURRENT scene state seen from `pose` (default: the
    learnable pose of view 0), or None when the needed capacity is
    unreasonable. Prefers the 2-D tiled backend (tighter culling); falls
    back to the 1-D binned one when the tile levels are out of range
    (giant splats). A failed probe logs a warning and returns None (auto
    then stays dense)."""
    if pose is None:
        pose = params.get_pose(0)
    try:
        with profiling.annotate("train.size_caps"):
            cand = _tiled_candidate(params, camera, pose)
            if cand is not None:
                return cand
            cf, dl = binned_view_requirements(params, pose, camera)
        if cf > _MAX_BINNED_CAP_FACTOR or dl > _MAX_BINNED_D_LEVELS:
            return None
        return f"pallas-binned:{cf}:{dl}"
    except Exception as e:  # noqa: BLE001 - auto must never kill training,
        # but a swallowed probe failure forfeits the faster backend, so it
        # is made visible
        _log.warning("backend auto: binned sizing probe failed (%s: %s); "
                     "falling back to dense", type(e).__name__, e)
        return None


def capacities_grew(old: str, new: str) -> bool:
    """True when capacity string `new`'s capacities exceed `old`'s in any
    dimension (smaller fresh requirements are still drop-free under the
    larger capacities). A kind change (tiled <-> binned) always counts."""
    okind, *ocaps = old.split(":")
    nkind, *ncaps = new.split(":")
    if okind != nkind or len(ocaps) != len(ncaps) or not ocaps:
        return old != new
    return any(int(nc) > int(oc) for oc, nc in zip(ocaps, ncaps))


def render(gaussians, camera, pose: Optional[torch.Tensor] = None,
           bg: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
           active_sh_degree: Optional[int] = None, chunk: int = 256,
           backend: str = "oracle") -> RenderOut:
    """Render one view.

    pose: optional [7] learnable w2c pose overriding camera.pose (pass
      `gaussians.get_pose(uid)` during joint optimisation).
    bg: [3] background (default black); differentiable.
    active_sh_degree: SH bands to evaluate; defaults to the maximum.
    chunk: splats per scan step of the oracle backend.
    backend: see the module docstring.
    """
    backend = _check_backend(backend)
    if pose is None:
        pose = camera.pose
    if bg is None:
        bg = torch.zeros(3, device=pose.device)
    if active_sh_degree is None:
        active_sh_degree = gaussians.max_sh_degree
    h, w = camera.height, camera.width
    packed, cols = prepare_packed_splats(
        gaussians, pose, camera.fx, camera.fy, camera.cx, camera.cy,
        scale_modifier, active_sh_degree, h, w)
    profiling.mark_grad(packed, "raster_bwd")
    lists = (capacity_lists(packed, h, w, backend) if is_capacity(backend)
             else None)
    if lists is not None:
        slots, geom, forward, backward = lists
        out = composite_out(*composite_lists(packed, slots, geom, h, w,
                                             forward, backward), bg)
    elif backend == "oracle":
        acc, tfin, _ = rasterize.composite_plain(packed, h, w, chunk=chunk)
        out = rasterize.composite_out(acc, tfin, bg)
    else:  # "pallas", or a capacity signature demoted to it
        out = rasterize_pallas.composite_tiles_packed(packed, h, w, bg)
    return RenderOut(render=out.rgb, alpha=out.alpha, depth=out.depth,
                     radii=cols.radius, visibility=cols.valid)
