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

The capacity backends go through a rate-limited overflow guard: on the
first call for an (N, H, W, capacities) signature and every
_BINNED_CHECK_EVERY calls after, the lists' overflow flag is read; an
overflowing signature is demoted to the dense kernels for good, with a
warning, since the dense kernels never drop a splat. Inside a block of
steps that runs from a captured CUDA graph (utils/cuda_graphs.StepLoop),
nothing is read: every call ORs its lists' flag into a device tensor,
read once at the block's end (`recording_overflow`, `settle_overflow`).
Each demotion counts in the counter `render.demotions`
(utils/profiling.py). Inside a traced loop step the render marks the end
of the front end's columns ("frontend") and, in the backward, the
gradient reaching the packed splats ("raster_bwd").
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
from instantsplat_tpu_torch.ops.frontend import compute_columns
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
    order is deterministic; tied invalid rows contribute nothing."""
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


def _parse_binned_caps(backend: str):
    """"pallas-binned[:CF:DL]" -> (cap_factor | None, d_levels | None)."""
    parts = backend.split(":")
    if len(parts) == 3:
        return int(parts[1]), int(parts[2])
    return None, None


def _parse_tiled_caps(backend: str):
    """"pallas-tiled[:CF:DY:DX]" -> (cap_factor, dy, dx) or Nones."""
    parts = backend.split(":")
    if len(parts) == 4:
        return int(parts[1]), int(parts[2]), int(parts[3])
    return None, None, None


def _check_backend(backend: str) -> str:
    if backend == "auto":
        return "pallas"
    if not (backend in ("pallas", "oracle")
            or backend.startswith(("pallas-binned", "pallas-tiled"))):
        raise ValueError(f"unknown rasterizer backend: {backend}")
    return backend


_log = logging.getLogger(__name__)
_BINNED_CHECK_EVERY = 100


class _OverflowGuard:
    """Call counts and demoted signatures of the capacity backends; while a
    block of steps runs (utils/cuda_graphs.StepLoop), the block's overflow
    flags by signature."""

    def __init__(self):
        self.calls: dict = {}
        self.demoted: set = set()
        self.flags: Optional[dict] = None
        self.warnings: dict = {}  # signature -> warn() on its demotion

    def check(self, key, overflow_fn, warn) -> bool:
        """Whether signature `key` runs the dense kernels. Outside a block:
        count the call; on its first call and every _BINNED_CHECK_EVERY-th
        after, read overflow_fn() and, when it is True, demote `key` with
        warn(). Inside a block (recording_overflow): OR overflow_fn()'s
        device flag into the block's flag for `key`, with no host read;
        the block's end reads it and demotes with warn() (settle_overflow).
        A block's first calls run eagerly (StepLoop's warm-up), which is
        where a flag is made; a captured step writes into it on every
        replay."""
        if key in self.demoted:
            return True
        if self.flags is not None:
            overflow = overflow_fn()
            flag = self.flags.get(key)
            if flag is not None:
                flag.logical_or_(overflow)
            elif overflow.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"overflow guard: signature {key} first "
                                   "seen while a step was being captured")
            else:
                self.flags[key] = overflow.clone()
            self.warnings[key] = warn
            return False
        n = self.calls.get(key, 0)
        self.calls[key] = n + 1
        if n % _BINNED_CHECK_EVERY == 0 and bool(overflow_fn()):
            self.demoted.add(key)
            profiling.count("render.demotions")
            warn()
            return True
        return False


_guard = _OverflowGuard()


@contextlib.contextmanager
def recording_overflow(flags: dict):
    """Inside, every capacity-backend render ORs its lists' overflow flag
    into flags[signature] instead of reading it (see settle_overflow)."""
    old, _guard.flags = _guard.flags, flags
    try:
        yield
    finally:
        _guard.flags = old


def settle_overflow(flags: dict) -> bool:
    """At a block's end: read the block's flags (one host read) and demote,
    with the warning, each signature whose lists overflowed in any of its
    calls. -> True when one was demoted. The JAX package's scan checks
    nothing inside a block; the port checks every call and acts here."""
    keys = [k for k in flags if k not in _guard.demoted]
    if not keys:
        return False
    hit = torch.stack([flags[k] for k in keys]).cpu().tolist()
    for key, overflowed in zip(keys, hit):
        if overflowed:
            _guard.demoted.add(key)
            profiling.count("render.demotions")
            _guard.warnings[key]()
    return any(hit)


def _warn_demoted(key):
    if key[0] == "tiled":
        _log.warning(
            "tiled rasterizer capacity exhausted for N=%d %dx%d "
            "(pairs would be dropped); auto-switching this signature "
            "to the dense pallas backend. To keep tiling, re-probe "
            "tiled_view_requirements (current cf=%s dy=%s dx=%s).",
            *key[1:])
        return
    cf, dl = key[3:]
    remedy = (f"re-probe binned_view_requirements for fresh capacities "
              f"(current cap_factor={cf}, d_levels={dl})"
              if cf is not None else
              "raise rasterize_pallas_binned.CAP_FACTOR / D_LEVELS")
    _log.warning(
        "binned rasterizer bin capacity exhausted for N=%d %dx%d "
        "(pairs would be dropped); auto-switching this signature to "
        "the dense pallas backend. To keep binning, %s.", *key[:3], remedy)


def _columns(packed):
    return packed[:, :2], packed[:, 2:5], packed[:, 5], splat_valid(packed)


def _capacity_key(packed, height: int, width: int, backend: str):
    n = int(packed.shape[0])
    if backend.startswith("pallas-binned"):
        return (n, height, width, *_parse_binned_caps(backend))
    return ("tiled", n, height, width, *_parse_tiled_caps(backend))


def _binned_backend_or_dense(packed, height: int, width: int,
                             backend: str) -> str:
    """The backend to use for this call: `backend`, or "pallas" once its
    lists were found to overflow (port of the JAX driver's guard)."""
    cf, dl = _parse_binned_caps(backend)
    key = _capacity_key(packed, height, width, backend)
    dense = _guard.check(key, lambda: rasterize_pallas_binned.bin_overflow(
        *_columns(packed), height, width, cf, dl),
        lambda: _warn_demoted(key))
    return "pallas" if dense else backend


def _tiled_backend_or_dense(packed, height: int, width: int,
                            backend: str) -> str:
    """As _binned_backend_or_dense, for the 2-D tiled backend."""
    cf, dy, dx = _parse_tiled_caps(backend)
    key = _capacity_key(packed, height, width, backend)
    dense = _guard.check(key, lambda: rasterize_pallas_tiled.tile_overflow(
        *_columns(packed), height, width, cf, dy, dx),
        lambda: _warn_demoted(key))
    return "pallas" if dense else backend


def _recorded_lists(packed, height: int, width: int, backend: str):
    """Inside a block (recording_overflow): the capacity backend's lists,
    their overflow flag recorded for the block's end. -> [lists, geometry,
    forward kernel, backward kernel], or None once the signature is
    demoted (the dense kernels then run)."""
    key = _capacity_key(packed, height, width, backend)
    built = []

    def lists_overflow():
        if backend.startswith("pallas-binned"):
            built.extend(rasterize_pallas_binned.bin_lists(
                packed, height, width, *_parse_binned_caps(backend)))
            built.extend((rasterize_pallas_binned.K3,
                          rasterize_pallas_binned.K4))
        else:
            built.extend(rasterize_pallas_tiled.tile_lists(
                packed, height, width, *_parse_tiled_caps(backend)))
            built.extend((rasterize_pallas_tiled.K5,
                          rasterize_pallas_tiled.K6))
        return built[0].overflow

    if _guard.check(key, lists_overflow, lambda: _warn_demoted(key)):
        return None
    return built


def _sizing_columns(gaussians, pose, camera, scale_modifier):
    """Sorted splat columns of this view at SH degree 0, without a graph."""
    with torch.no_grad():
        packed, _ = prepare_packed_splats(
            gaussians, pose, camera.fx, camera.fy, camera.cx, camera.cy,
            scale_modifier, 0, camera.height, camera.width)
    return _columns(packed)


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
    recorded = None
    if _guard.flags is not None and backend.startswith(
            ("pallas-binned", "pallas-tiled")):
        recorded = _recorded_lists(packed, h, w, backend)
        if recorded is None:
            backend = "pallas"
    elif backend.startswith("pallas-binned"):
        backend = _binned_backend_or_dense(packed.detach(), h, w, backend)
    elif backend.startswith("pallas-tiled"):
        backend = _tiled_backend_or_dense(packed.detach(), h, w, backend)
    if recorded is not None:
        out = composite_out(*composite_lists(packed, *recorded[:2], h, w,
                                             *recorded[2:]), bg)
    elif backend == "pallas":
        out = rasterize_pallas.composite_tiles_packed(packed, h, w, bg)
    elif backend == "oracle":
        acc, tfin, _ = rasterize.composite_plain(packed, h, w, chunk=chunk)
        out = rasterize.composite_out(acc, tfin, bg)
    elif backend.startswith("pallas-binned"):
        cf, dl = _parse_binned_caps(backend)
        out = rasterize_pallas_binned.composite_tiles_binned_packed(
            packed, h, w, bg, cap_factor=cf, d_levels=dl)
    else:
        cf, dy, dx = _parse_tiled_caps(backend)
        out = rasterize_pallas_tiled.composite_tiles_2d_packed(
            packed, h, w, bg, cap_factor=cf, dy_levels=dy, dx_levels=dx)
    return RenderOut(render=out.rgb, alpha=out.alpha, depth=out.depth,
                     radii=cols.radius, visibility=cols.valid)
