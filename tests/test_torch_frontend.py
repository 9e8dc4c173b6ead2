"""The port's geometry front-end against instantsplat_tpu.ops.frontend:
all 12 FrontendCols and the VJP with respect to the pose and every
Gaussian parameter, on the same seeded numpy inputs (rtol 1e-5). Then the
two routes of the port's own front end: on CPU tensors
prepare_packed_splats is compute_columns, the CUDA route's wrapper
(frontend_rows) refuses what its kernels cannot read and names the fault,
and the kernels' source, built for the host (tests/torch_frontend_host.py),
gives compute_columns' columns and autograd's gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.ops import frontend as jfront
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.ops import frontend
from instantsplat_tpu_torch.render.driver import prepare_packed_splats
from torch_frontend_cases import frontend_scene, packed_plain
from torch_frontend_host import host_library, on_host

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

H, W = 48, 64
FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
FLOAT_COLS = ("mx", "my", "ca", "cb", "cc", "log_op", "r", "g", "b", "depth")


def _inputs(seed=0, n=300, deg=3):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)) * [1.2, 1.0, 0.8] + [0.0, 0.0, 3.0]
    xyz[:6, 2] = [0.1, 0.19, 0.21, -1.0, 1e-9, 0.5]  # near/behind the camera
    xyz[6:10, :2] = [[30.0, 0.0], [-30.0, 1.0], [0.0, 25.0], [2.0, -25.0]]
    arrays = dict(
        xyz=xyz,
        features_dc=rng.normal(size=(n, 1, 3)) * 0.8,
        features_rest=rng.normal(size=(n, (deg + 1) ** 2 - 1, 3)) * 0.3,
        scaling=rng.normal(size=(n, 3)) * 0.5 - 2.5,
        rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(size=(n, 1)) * 2.0,
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    q = rng.normal(size=4) * [0.05, 0.05, 0.05, 0.05] + [1.0, 0, 0, 0]
    pose = np.concatenate([q, rng.normal(size=3) * 0.1]).astype(np.float32)
    return arrays, pose


def _jax_cols(arrays, pose, deg, active):
    g = JGaussians(**{k: jnp.asarray(v) for k, v in arrays.items()},
                   cam_poses=jnp.zeros((0, 7)), max_sh_degree=deg)
    return jfront.compute_columns(
        g, jnp.asarray(pose), jnp.float32(60.0), jnp.float32(58.0),
        jnp.float32((W - 1) / 2), jnp.float32((H - 1) / 2), jnp.float32(1.0),
        active, H, W)


def _torch_cols(tensors, pose_t, deg, active):
    g = GaussianModel(**tensors, cam_poses=torch.zeros((0, 7)),
                      max_sh_degree=deg)
    f32 = lambda v: torch.tensor(np.float32(v))  # noqa: E731
    return frontend.compute_columns(
        g, pose_t, f32(60.0), f32(58.0), f32((W - 1) / 2), f32((H - 1) / 2),
        1.0, active, H, W)


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_columns_match_jax(active):
    arrays, pose = _inputs(seed=active)
    ref = _jax_cols(arrays, pose, 3, active)
    got = _torch_cols({k: torch.tensor(v) for k, v in arrays.items()},
                      torch.tensor(pose), 3, active)
    valid = np.asarray(ref.valid)
    assert 0 < valid.sum() < len(valid)  # both culled and kept splats
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radius.numpy(), np.asarray(ref.radius))
    for name in FLOAT_COLS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        # compare where the JAX value is finite-sized; culled rows included
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(
            b).max(), err_msg=name)


@pytest.mark.parametrize("active", [1, 3])
def test_vjp_matches_jax(active):
    arrays, pose = _inputs(seed=10 + active)
    rng = np.random.default_rng(99)
    cot = {c: rng.normal(size=len(arrays["xyz"])).astype(np.float32)
           for c in FLOAT_COLS}

    def jloss(params, p):
        cols = _jax_cols(params, p, 3, active)
        return sum(jnp.sum(getattr(cols, c) * cot[c]) for c in FLOAT_COLS)

    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    jg, jp = jax.grad(jloss, argnums=(0, 1))(jarr, jnp.asarray(pose))

    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in arrays.items()}
    pose_t = torch.tensor(pose, requires_grad=True)
    cols = _torch_cols(tensors, pose_t, 3, active)
    loss = sum(torch.sum(getattr(cols, c) * torch.tensor(cot[c]))
               for c in FLOAT_COLS)
    grads = torch.autograd.grad(loss, [pose_t] + [tensors[k] for k in FIELDS])
    # relative to each gradient's scale: sums of cancelling terms make some
    # entries small against the rest
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jp)).max())
    for k, g in zip(FIELDS, grads[1:]):
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=k)


def _equal(a, b):
    return torch.equal(torch.nan_to_num(a, 0.0, 1e38, -1e38),
                       torch.nan_to_num(b, 0.0, 1e38, -1e38)) and torch.equal(
                           a.isnan(), b.isnan())


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_cpu_route_is_compute_columns(degree):
    """On CPU tensors prepare_packed_splats returns compute_columns' own
    FrontendCols and its columns packed and sorted by the depth key."""
    g, pose, fx, fy, cx, cy = frontend_scene(400, H, W, degree, "cpu")
    packed, cols = prepare_packed_splats(g, pose, fx, fy, cx, cy, 1.0, degree,
                                         H, W)
    want, plain = packed_plain(g, pose, fx, fy, cx, cy, degree, H, W)
    for name, a, b in zip(frontend.FrontendCols._fields, cols, plain):
        assert _equal(a, b), name
    perm = torch.sort(want[:, 9], stable=True).indices
    assert _equal(packed, want[perm])


def _refusal_cases():
    def field(name, fn):
        def make(g, pose, view):
            setattr(g, name, fn(getattr(g, name)))
            return g, pose, view, 1
        return make

    def view(k, fn):
        def make(g, pose, view):
            view = list(view)
            view[k] = fn(view[k])
            return g, pose, view, 1
        return make

    return {
        "float64 xyz": (field("xyz", lambda x: x.double()),
                        "xyz is torch.float64, not torch.float32"),
        "strided rotation": (field("rotation", lambda x: x.T.contiguous().T),
                             "rotation is not contiguous"),
        "flat opacity": (field("opacity", lambda x: x[:, 0]),
                         r"opacity is \(400,\), not \[400, 1\]"),
        "short features_rest": (field("features_rest",
                                      lambda x: x[:, :2].contiguous()),
                                "features_rest holds 2 coefficients"),
        "degree 4": (lambda g, p, v: (g, p, v, 4), "SH degree 4 is outside 0-3"),
        "degree -1": (lambda g, p, v: (g, p, v, -1),
                      "SH degree -1 is outside 0-3"),
        "float64 pose": (lambda g, p, v: (g, p.double(), v, 1),
                         "the pose is torch.float64"),
        "fx with a gradient": (view(0, lambda x: x.requires_grad_(True)),
                               "fx requires grad"),
        "cy a Python float": (view(3, float),
                              "cy must be a float32 scalar tensor on cpu"),
    }


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_frontend_rows_refuses_and_names_the_fault(case):
    """frontend_rows checks its inputs before any launch: each refusal is a
    ValueError that names the field and the fault."""
    make, message = _refusal_cases()[case]
    g, pose, *view = frontend_scene(400, H, W, 0, "cpu")
    g, pose, view, degree = make(g, pose, view)
    with pytest.raises(ValueError, match=message):
        frontend.frontend_rows(g, pose, *view, 1.0, degree, H, W)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("frontend_host"))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_kernel_source_on_the_host_matches_compute_columns(
        degree, host_lib, monkeypatch):
    """csrc/frontend.cu built for the host: its rows against compute_columns'
    (radius and valid exactly, the floats to the host's expf/logf), its
    gradients of every field and of the pose (pose-only too) against
    autograd's; two blocks and a ragged one, so the pose sums cross
    blocks."""
    on_host(monkeypatch, host_lib)
    g, pose, fx, fy, cx, cy = frontend_scene(700, H, W, 20 + degree, "cpu",
                                             degenerate=False,
                                             identity=degree % 2 == 1)
    leaves = [getattr(g, f) for f in frontend.FIELDS] + [pose]
    for x in leaves:
        x.requires_grad_(True)
    want, plain = packed_plain(g, pose, fx, fy, cx, cy, degree, H, W)
    rows, key, cols = frontend.frontend_rows(g, pose, fx, fy, cx, cy, 1.0,
                                             degree, H, W)
    assert torch.equal(cols.valid, plain.valid)
    assert torch.equal(cols.radius, plain.radius)
    assert torch.equal(key, rows[:, 9].detach())
    torch.testing.assert_close(rows, want, rtol=1e-5, atol=1e-6)
    upstream = torch.randn((700, 10), generator=torch.Generator().manual_seed(
        degree))
    ref = torch.autograd.grad(want, leaves, upstream, allow_unused=True)
    got = torch.autograd.grad(rows, leaves, upstream)
    for name, a, b in zip([*frontend.FIELDS, "pose"], got, ref):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()) + 1e-30,
                                   msg=name)
    for x in leaves[:-1]:
        x.requires_grad_(False)
    rows, _, _ = frontend.frontend_rows(g, pose, fx, fy, cx, cy, 1.0, degree,
                                        H, W)
    (alone,) = torch.autograd.grad(rows, [pose], upstream)
    assert torch.equal(alone, got[-1])
