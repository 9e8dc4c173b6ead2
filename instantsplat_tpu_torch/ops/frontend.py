"""Geometry front-end: activations, covariance, SH shading and EWA
projection (port of instantsplat_tpu/ops/frontend.py).

The pose stays in autograd, so camera-pose gradients flow through the view
transform and the EWA Jacobian. Semantics kept from the reference:
covariance (R S)(R S)^T from normalized wxyz quaternions, camera-frame SH
view directions with color = max(SH + 0.5, 0), the EWA Jacobian with the
1.3*tan(fov/2) frustum clamp, the +0.3 px low-pass, the 3-sigma ceil
radius, the z > 0.2 near cull, det > 0 and the screen-bounds test.

Two routes. `compute_columns` is [N]-column arithmetic that autograd
differentiates: the CPU route and the plain version the tests hold the
kernels to. `frontend_rows` is the CUDA route (render/driver.py::
prepare_packed_splats on CUDA tensors): one launch of frontend_forward
(csrc/frontend.cu; its header note says what bounds it and how it
rounds) writes the packed rows the depth sort gathers, and in the
backward one launch of frontend_backward writes the Gaussians' gradients
and one of frontend_pose_reduce sums the pose's, the gradients autograd
asks for only. SH degrees 0-3.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from instantsplat_tpu_torch.ops.projection import LOW_PASS, NEAR_CULL_Z
from instantsplat_tpu_torch.ops.cuda_build import Kernel
from instantsplat_tpu_torch.utils import transforms as T
from instantsplat_tpu_torch.utils.sh import C0, C1, C2, C3, C4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the inputs both directions read: six Gaussian fields, the SH row length,
# R, t, fx, fy, cx, cy, the scale modifier, degree, N, H, W
_INPUTS = [_P] * 6 + [_I] + [_P] * 6 + [_F, _I, _I, _I, _I]
FE_FORWARD = Kernel("frontend_forward", _INPUTS + [_P] * 5,
                    source="frontend.cu")
FE_BACKWARD = Kernel("frontend_backward", _INPUTS + [_P] * 9,
                     source="frontend.cu")
FE_POSE = Kernel("frontend_pose_reduce", [_P, _I, _P, _P],
                 source="frontend.cu")
KERNEL_DEGREES = (0, 1, 2, 3)  # the SH degrees the kernels are built for
THREADS = 256  # Gaussians a block (csrc/frontend.cu THREADS)
POSE = 12  # a block's pose partials: dL/dR row-major, then dL/dt
# the Gaussian fields the kernels read, and each one's shape after N
FIELDS = {"xyz": (3,), "rotation": (4,), "scaling": (3,), "opacity": (1,),
          "features_dc": (1, 3), "features_rest": (None, 3)}


class FrontendCols(NamedTuple):
    """Per-Gaussian screen-space columns, each [N]. From the kernels'
    route (frontend_rows) log_op and depth hold -inf and 1e30 on culled
    rows."""

    mx: torch.Tensor  # pixel x of the 2D mean
    my: torch.Tensor  # pixel y
    ca: torch.Tensor  # conic (inverse 2D covariance) a
    cb: torch.Tensor  # conic b
    cc: torch.Tensor  # conic c
    log_op: torch.Tensor  # log activated opacity
    r: torch.Tensor  # shaded color channels
    g: torch.Tensor
    b: torch.Tensor
    depth: torch.Tensor  # view-space z
    radius: torch.Tensor  # 3-sigma pixel radius (0 = culled)
    valid: torch.Tensor  # bool


def _max(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) with JAX's tie gradient (half to each side), where
    torch.clamp would pass the whole gradient. The floor is filled on
    the device (no host copy, so the front end can be captured)."""
    return torch.maximum(x, x.new_full((), floor))


def _sh_colors(deg: int, feat_t, x, y, z):
    """feat_t [K, 3, N] SH coefficients, unit view dirs (x, y, z) [N] ->
    3 x [N] color columns (basis shared across channels)."""
    basis = []
    if deg >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if deg >= 3:
        basis += [
            C3[0] * y * (3 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4 * zz - xx - yy),
            C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            C3[4] * x * (4 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3 * yy),
        ]
    if deg >= 4:
        basis += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3 * xx - yy),
            C4[2] * xy * (7 * zz - 1),
            C4[3] * yz * (7 * zz - 3),
            C4[4] * (zz * (35 * zz - 30) + 3),
            C4[5] * xz * (7 * zz - 3),
            C4[6] * (xx - yy) * (7 * zz - 1),
            C4[7] * xz * (xx - 3 * yy),
            C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    out = []
    for c in range(3):
        col = C0 * feat_t[0, c]
        for k, bk in enumerate(basis):
            col = col + bk * feat_t[k + 1, c]
        out.append(col)
    return out


def _cov3d_cols(rot_t, s0, s1, s2):
    """Quaternion columns [4, N] + activated scales -> the six world
    covariance components (c00, c01, c02, c11, c12, c22) of (R S)(R S)^T."""
    w, x, y, z = rot_t[0], rot_t[1], rot_t[2], rot_t[3]
    inv = torch.rsqrt(w * w + x * x + y * y + z * z + 1e-12)
    w, x, y, z = w * inv, x * inv, y * inv, z * inv
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22
    return c00, c01, c02, c11, c12, c22


def compute_columns(gaussians, pose: torch.Tensor, fx, fy, cx, cy,
                    scale_modifier, active_sh_degree: int, height: int,
                    width: int) -> FrontendCols:
    """Activate, transform by `pose` ([7] w2c, differentiable), SH-shade
    and project every Gaussian. fx, fy, cx, cy are 0-dim float32 tensors."""
    R = T.quat_to_rotmat(pose[:4])
    t = pose[4:7]

    x3, y3, z3 = gaussians.xyz.unbind(1)
    rot_t = gaussians.rotation.T
    sc_t = torch.exp(gaussians.scaling.T) * scale_modifier
    log_op = torch.log(_max(torch.sigmoid(gaussians.opacity[:, 0]), 1e-12))

    # view-space means (the pose-gradient path)
    vx = R[0, 0] * x3 + R[0, 1] * y3 + R[0, 2] * z3 + t[0]
    vy = R[1, 0] * x3 + R[1, 1] * y3 + R[1, 2] * z3 + t[1]
    vz = R[2, 0] * x3 + R[2, 1] * y3 + R[2, 2] * z3 + t[2]

    # camera-frame SH view directions (reference quirk)
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    dinv = 1.0 / _max(norm, 1e-8)
    feats = torch.cat([gaussians.features_dc, gaussians.features_rest], dim=1)
    feat_t = feats.permute(1, 2, 0)  # [K, 3, N]
    cols_rgb = _sh_colors(active_sh_degree, feat_t, vx * dinv, vy * dinv,
                          vz * dinv)
    r, g, b = (_max(cval + 0.5, 0.0) for cval in cols_rgb)

    c00, c01, c02, c11, c12, c22 = _cov3d_cols(
        rot_t, sc_t[0], sc_t[1], sc_t[2])

    # EWA projection
    tan_fovx = width / (2.0 * fx)
    tan_fovy = height / (2.0 * fy)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    inv_z = 1.0 / torch.where(torch.abs(vz) < 1e-8,
                              torch.full_like(vz, 1e-8), vz)
    txz = torch.minimum(torch.maximum(vx * inv_z, -limx), limx)
    tyz = torch.minimum(torch.maximum(vy * inv_z, -limy), limy)
    tx = txz * vz
    ty = tyz * vz

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z * inv_z
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z * inv_z

    m00 = j00 * R[0, 0] + j02 * R[2, 0]
    m01 = j00 * R[0, 1] + j02 * R[2, 1]
    m02 = j00 * R[0, 2] + j02 * R[2, 2]
    m10 = j11 * R[1, 0] + j12 * R[2, 0]
    m11 = j11 * R[1, 1] + j12 * R[2, 1]
    m12 = j11 * R[1, 2] + j12 * R[2, 2]

    sm0_0 = c00 * m00 + c01 * m01 + c02 * m02
    sm0_1 = c01 * m00 + c11 * m01 + c12 * m02
    sm0_2 = c02 * m00 + c12 * m01 + c22 * m02
    sm1_0 = c00 * m10 + c01 * m11 + c02 * m12
    sm1_1 = c01 * m10 + c11 * m11 + c12 * m12
    sm1_2 = c02 * m10 + c12 * m11 + c22 * m12
    a = m00 * sm0_0 + m01 * sm0_1 + m02 * sm0_2 + LOW_PASS
    bq = m00 * sm1_0 + m01 * sm1_1 + m02 * sm1_2
    c = m10 * sm1_0 + m11 * sm1_1 + m12 * sm1_2 + LOW_PASS

    det = a * c - bq * bq
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    ca = c * inv_det
    cb = -bq * inv_det
    cc = a * inv_det

    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(_max(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    mx = fx * tx * inv_z + cx
    my = fy * ty * inv_z + cy

    valid = ((vz > NEAR_CULL_Z) & (det > 0)
             & (mx + radius > 0) & (mx - radius < width)
             & (my + radius > 0) & (my - radius < height))
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return FrontendCols(mx, my, ca, cb, cc, log_op, r, g, b, vz, radius,
                        valid)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


class _FrontendCuda(torch.autograd.Function):
    """The six Gaussian fields, R [3,3], t [3], fx, fy, cx, cy (0-dim, on
    the device) -> (rows [N,10], key [N], radius [N], valid [N]): one
    frontend_forward launch; the backward launches frontend_backward and,
    when the pose needs it, frontend_pose_reduce."""

    @staticmethod
    def forward(ctx, xyz, rotation, scaling, opacity, features_dc,
                features_rest, R, t, fx, fy, cx, cy, scale_modifier, degree,
                height, width):
        n, dev = xyz.shape[0], xyz.device
        rows = torch.empty((n, 10), device=dev)
        key = torch.empty(n, device=dev)
        radius = torch.empty(n, device=dev)
        valid = torch.empty(n, dtype=torch.bool, device=dev)
        inputs = (xyz, rotation, scaling, opacity, features_dc,
                  features_rest, R, t, fx, fy, cx, cy)
        ctx.save_for_backward(*inputs)
        ctx.args = (scale_modifier, degree, n, height, width)
        ctx.mark_non_differentiable(key, radius, valid)
        if n:
            with torch.cuda.device(dev):
                FE_FORWARD(*_launch_inputs(inputs, ctx.args), rows.data_ptr(),
                           key.data_ptr(), radius.data_ptr(),
                           valid.data_ptr(), _stream())
        return rows, key, radius, valid

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rows, g_key, g_radius, g_valid):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad
        grads = [torch.empty_like(x) if need[k] else None
                 for k, x in enumerate(inputs[:6])]
        n, dev = inputs[0].shape[0], inputs[0].device
        pose = need[6] or need[7]
        blocks = -(-n // THREADS)
        out = (torch.empty if n else torch.zeros)(POSE, device=dev)
        if n:
            partials = (torch.empty((blocks, POSE), device=dev) if pose
                        else None)
            with torch.cuda.device(dev):
                FE_BACKWARD(*_launch_inputs(inputs, ctx.args),
                            g_rows.contiguous().data_ptr(),
                            *map(_ptr, grads), _ptr(partials), _stream())
                if pose:
                    FE_POSE(partials.data_ptr(), blocks, out.data_ptr(),
                            _stream())
        d_R = out[:9].view(3, 3) if need[6] else None
        d_t = out[9:] if need[7] else None
        return (*grads, d_R, d_t) + (None,) * 8


def _launch_inputs(inputs, args):
    scale_modifier, degree, n, height, width = args
    return (*(x.data_ptr() for x in inputs[:6]), inputs[5].shape[1],
            *(x.data_ptr() for x in inputs[6:]), scale_modifier, degree, n,
            height, width)


def _view_scalar(v, name: str, device) -> torch.Tensor:
    """fx, fy, cx or cy, which the kernels read through its pointer (a
    captured step gathers its view on the device): a float32 scalar tensor
    on the Gaussians' device, outside autograd."""
    if not (torch.is_tensor(v) and v.device == device
            and v.dtype == torch.float32 and v.numel() == 1):
        raise ValueError(f"frontend_rows: {name} must be a float32 scalar "
                         f"tensor on {device}, not {v!r}")
    if v.requires_grad:
        raise ValueError(f"frontend_rows: {name} requires grad; the kernels "
                         "read the intrinsics and do not differentiate them")
    return v.reshape(())


def _checked_fields(gaussians, degree: int, device) -> list:
    if degree not in KERNEL_DEGREES:
        raise ValueError(f"frontend_rows: SH degree {degree} is outside "
                         f"{KERNEL_DEGREES[0]}-{KERNEL_DEGREES[-1]}, the "
                         "degrees the kernels are built for")
    n = gaussians.xyz.shape[0]
    out = []
    for name, shape in FIELDS.items():
        x = getattr(gaussians, name)
        if x.dtype != torch.float32:
            raise ValueError(f"frontend_rows: {name} is {x.dtype}, not "
                             "torch.float32")
        if x.device != device:
            raise ValueError(f"frontend_rows: {name} is on {x.device}, xyz "
                             f"on {device}")
        if (x.dim() != 1 + len(shape) or x.shape[0] != n or any(
                want is not None and got != want
                for got, want in zip(x.shape[1:], shape))):
            want = ", ".join("K" if d is None else str(d) for d in shape)
            raise ValueError(f"frontend_rows: {name} is {tuple(x.shape)}, "
                             f"not [{n}, {want}]")
        if not x.is_contiguous():
            raise ValueError(f"frontend_rows: {name} is not contiguous")
        out.append(x)
    if out[-1].shape[1] < (degree + 1) ** 2 - 1:
        raise ValueError(f"frontend_rows: features_rest holds "
                         f"{out[-1].shape[1]} coefficients a Gaussian, SH "
                         f"degree {degree} reads {(degree + 1) ** 2 - 1}")
    return out


def frontend_rows(gaussians, pose: torch.Tensor, fx, fy, cx, cy,
                  scale_modifier, active_sh_degree: int, height: int,
                  width: int):
    """The CUDA route of the front end: -> (rows [N, 10], key [N],
    FrontendCols). rows are the packed splat rows in Gaussian order (mx,
    my, conic a b c, log-opacity with -inf on culled rows, r, g, b, the
    depth key with the finite 1e30 sentinel on culled rows), what
    compute_columns' columns give when stacked so; key is column 9 again,
    contiguous and outside autograd, for the depth sort. The FrontendCols
    are views of rows (their log_op and depth carry the culled rows'
    -inf and 1e30) and the kernel's radius and valid. Differentiable with
    respect to the six Gaussian fields and `pose`; the intrinsics are
    read through device pointers and not differentiated."""
    dev = gaussians.xyz.device
    fields = _checked_fields(gaussians, active_sh_degree, dev)
    if pose.dtype != torch.float32 or pose.device != dev:
        raise ValueError(f"frontend_rows: the pose is {pose.dtype} on "
                         f"{pose.device}, not torch.float32 on {dev}")
    R = T.quat_to_rotmat(pose[:4]).contiguous()
    t = pose[4:7].contiguous()
    view = [_view_scalar(v, name, dev)
            for v, name in zip((fx, fy, cx, cy), ("fx", "fy", "cx", "cy"))]
    rows, key, radius, valid = _FrontendCuda.apply(
        *fields, R, t, *view, float(scale_modifier), active_sh_degree,
        height, width)
    cols = FrontendCols(*rows.unbind(1), radius, valid)
    return rows, key, cols
