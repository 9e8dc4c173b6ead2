"""The port's structured render path and last pure helpers against the JAX
package, on the same seeded numpy inputs, at the tolerances of
tests/test_golden.py:39-66 (oracle 2e-5; kernel 5e-4, grad rtol 5e-3):

- ops/projection: project_gaussians (forward and the gradient in means,
  covariances, R and t; and against compute_columns' columns on a
  GaussianModel), pack_pixel_features;
- ops/rasterize: sort_by_depth, composite(with_depth=False, y_offset);
- render/driver.prepare_sorted_splats (valid rows row for row: the sort
  is stable in the port and unstable in JAX, so the invalid rows, which
  share one key, are compared as a count);
- the structured compositors: composite_tiles against JAX's in interpret
  mode and against rasterize.composite, composite_tiles_binned and
  composite_tiles_2d against JAX's;
- utils: eval_sh (degrees 0-4), sh_to_rgb, matrix_to_pose, the GL
  matrices; models: stack_cameras, the Camera and GaussianModel helpers;
  eval: lpips_pair and its gradient; pipelines: add_opt_group;
- every port CLI's help (nothing may say "not ported").

JAX functions are jitted whole (eager JAX compiles op by op).
"""

import importlib
from argparse import ArgumentParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.eval import image_metrics as jim
from instantsplat_tpu.models import camera as jcam
from instantsplat_tpu.models.gaussians import GaussianModel as JGaussians
from instantsplat_tpu.ops import projection as jproj
from instantsplat_tpu.ops import rasterize as jras
from instantsplat_tpu.ops import rasterize_pallas as jrp
from instantsplat_tpu.ops import rasterize_pallas_binned as jb
from instantsplat_tpu.ops import rasterize_pallas_tiled as jt
from instantsplat_tpu.pipelines import config as jconfig
from instantsplat_tpu.render import driver as jdriver
from instantsplat_tpu.utils import graphics as jgraphics
from instantsplat_tpu.utils import sh as jsh
from instantsplat_tpu.utils import transforms as jT
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.eval import image_metrics as im
from instantsplat_tpu_torch.models import camera as cam
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.ops import projection, rasterize
from instantsplat_tpu_torch.ops import rasterize_pallas as RP
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as B
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as T
from instantsplat_tpu_torch.ops.frontend import compute_columns
from instantsplat_tpu_torch.pipelines import config
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.utils import graphics, sh
from instantsplat_tpu_torch.utils import transforms as pT
from test_torch_capacity import random_splats
from test_torch_frontend import _inputs as _gaussians

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

H, W = 48, 64
FX, FY = 60.0, 58.0
CX, CY = (W - 1) / 2, (H - 1) / 2
PORT_CLIS = ("demo", "init_geo", "init_test_pose", "metrics", "pretrain",
             "render", "run_eval", "run_infer", "train")


def _close(got, want, rtol, atol, err_msg="", relative=True):
    """allclose; atol is relative to the reference's largest value unless
    relative=False."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=err_msg)


def _models(arrays, deg=3):
    poses = np.zeros((2, 7), np.float32)
    poses[:, 0] = 1.0
    jg = JGaussians(**{k: jnp.asarray(v) for k, v in arrays.items()},
                    cam_poses=jnp.asarray(poses), max_sh_degree=deg)
    g = GaussianModel(**{k: torch.tensor(v) for k, v in arrays.items()},
                      cam_poses=torch.tensor(poses), max_sh_degree=deg)
    return jg, g


def _f32(v):
    return torch.tensor(np.float32(v))


# ---- ops/projection ----------------------------------------------------


def _projection_inputs(seed=3, n=300):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)) * [1.2, 1.0, 0.8] + [0.0, 0.0, 3.0]
    means[:5, 2] = [0.1, 0.19, 0.21, -1.0, 0.5]  # the near cull
    means[5:8, :2] = [[30.0, 0.0], [-30.0, 1.0], [0.0, 25.0]]  # clamp, cull
    L = rng.normal(size=(n, 3, 3)) * 0.05
    cov = L @ np.swapaxes(L, 1, 2) + 1e-4 * np.eye(3)
    q = rng.normal(size=4) * 0.1 + [1.0, 0, 0, 0]
    R = np.asarray(jT.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q))))
    t = rng.normal(size=3) * 0.1
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f(means), f(cov), f(R), f(t)


_j_project = jax.jit(jproj.project_gaussians,
                     static_argnames=("width", "height"))


def test_project_gaussians_matches_jax():
    arrs = _projection_inputs()
    intr = dict(fx=np.float32(FX), fy=np.float32(FY), cx=np.float32(CX),
                cy=np.float32(CY))
    ref = _j_project(*map(jnp.asarray, arrs), **intr, width=W, height=H)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    got = projection.project_gaussians(
        *ts, *(torch.tensor(v) for v in intr.values()), W, H)
    valid = np.asarray(ref.valid)
    assert 0 < valid.sum() < len(valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.radius.detach().numpy(),
                                  np.asarray(ref.radius))
    for name in ("mean2d", "cov2d", "conic", "depth"):
        _close(getattr(got, name), getattr(ref, name), 2e-5, 2e-5, name)

    rng = np.random.default_rng(4)
    cots = [rng.normal(size=np.shape(getattr(ref, n))).astype(np.float32)
            for n in ("mean2d", "cov2d", "conic", "depth")]
    mask = valid.astype(np.float32)  # culled rows' conics are arbitrary

    def jloss(m, c, R, t):
        p = jproj.project_gaussians(m, c, R, t, **intr, width=W, height=H)
        return (jnp.sum(p.mean2d * cots[0]) + jnp.sum(p.cov2d * cots[1])
                + jnp.sum(p.conic * cots[2] * mask[:, None])
                + jnp.sum(p.depth * cots[3]))

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, arrs))
    c = [torch.tensor(x) for x in cots]
    loss = ((got.mean2d * c[0]).sum() + (got.cov2d * c[1]).sum()
            + (got.conic * c[2] * torch.tensor(mask)[:, None]).sum()
            + (got.depth * c[3]).sum())
    for name, g, r in zip(("means", "cov3d", "R", "t"),
                          torch.autograd.grad(loss, ts), jgrads):
        _close(g, r, 5e-3, 1e-6, name)


def test_project_gaussians_matches_compute_columns():
    """The structured projection of a GaussianModel's means and
    covariances is the main path's column form."""
    arrays, pose = _gaussians(seed=5)
    _, g = _models(arrays)
    pose_t = torch.tensor(pose)
    cols = compute_columns(g, pose_t, _f32(FX), _f32(FY), _f32(CX),
                           _f32(CY), 1.0, 0, H, W)
    p = projection.project_gaussians(
        g.xyz, g.get_covariance(), pT.quat_to_rotmat(pose_t[:4]),
        pose_t[4:], _f32(FX), _f32(FY), _f32(CX), _f32(CY), W, H)
    np.testing.assert_array_equal(p.valid.numpy(), cols.valid.numpy())
    v = cols.valid
    _close(p.mean2d[v], torch.stack([cols.mx, cols.my], 1)[v], 2e-5, 2e-5)
    _close(p.conic[v], torch.stack([cols.ca, cols.cb, cols.cc], 1)[v],
           2e-5, 2e-5)
    _close(p.depth, cols.depth, 2e-5, 2e-5)
    # the 3-sigma radius is a ceil: equal but where rounding crosses it
    assert (p.radius == cols.radius).float().mean() > 0.99


def test_pack_pixel_features_matches_jax():
    rng = np.random.default_rng(6)
    mean2d = rng.uniform(0, 64, (200, 2)).astype(np.float32)
    conic = rng.uniform(0.1, 2.0, (200, 3)).astype(np.float32)
    ref = jax.jit(jproj.pack_pixel_features)(jnp.asarray(mean2d),
                                             jnp.asarray(conic))
    got = projection.pack_pixel_features(torch.tensor(mean2d),
                                         torch.tensor(conic))
    _close(got, ref, 1e-6, 1e-7)


def test_pack_splats_and_constants_match_jax():
    arrs = random_splats(24, 100, H, W)
    ref = jax.jit(jrp.pack_splats)(*map(jnp.asarray, arrs))
    got = RP.pack_splats(*map(torch.as_tensor, arrs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (projection.NEAR_CULL_Z, projection.LOW_PASS) == (
        jproj.NEAR_CULL_Z, jproj.LOW_PASS)
    assert projection.ProjectedGaussians._fields == \
        jproj.ProjectedGaussians._fields


# ---- ops/rasterize and the driver -----------------------------------------


def test_sort_by_depth_matches_jax_on_the_valid_prefix():
    rng = np.random.default_rng(7)
    depth = rng.uniform(1, 10, 500).astype(np.float32)
    depth[::7] = depth[3]  # ties among valid depths
    valid = rng.uniform(size=500) > 0.2
    ref = np.asarray(jax.jit(jras.sort_by_depth)(jnp.asarray(depth),
                                                 jnp.asarray(valid)))
    got = rasterize.sort_by_depth(torch.tensor(depth),
                                  torch.tensor(valid)).numpy()
    k = int(valid.sum())
    np.testing.assert_array_equal(got[:k], ref[:k])
    assert set(got[k:]) == set(ref[k:]) == set(np.nonzero(~valid)[0])


def test_prepare_sorted_splats_matches_jax():
    arrays, pose = _gaussians(seed=8)
    jg, g = _models(arrays)
    args = (np.float32(FX), np.float32(FY), np.float32(CX), np.float32(CY))
    jfn = jax.jit(jdriver.prepare_sorted_splats,
                  static_argnames=("active_sh_degree", "height", "width"))
    (jsplats, jcols) = jfn(jg, jnp.asarray(pose), *args, np.float32(1.0),
                           active_sh_degree=2, height=H, width=W)
    splats, cols = driver.prepare_sorted_splats(
        g, torch.tensor(pose), *map(_f32, args), 1.0, 2, H, W)
    valid = splats[5].numpy()
    k = int(np.asarray(jsplats[5]).sum())
    assert 0 < k < len(valid) and valid.sum() == k and valid[:k].all()
    np.testing.assert_array_equal(cols.valid.numpy(), np.asarray(jcols.valid))
    for name, got, ref in zip(("mean2d", "conic", "log_opacity", "colors",
                               "depth"), splats[:5], jsplats[:5]):
        _close(got[:k], np.asarray(ref)[:k], 1e-5, 1e-6, name)
    assert torch.isneginf(splats[2][k:]).all()
    assert (splats[4][k:] == 1e30).all()
    # views of prepare_packed_splats' one packed array
    packed, _ = driver.prepare_packed_splats(
        g, torch.tensor(pose), *map(_f32, args), 1.0, 2, H, W)
    assert torch.equal(torch.cat([splats[0], splats[1], splats[2][:, None],
                                  splats[3], splats[4][:, None]], 1), packed)


def test_composite_without_depth_and_row_offset_matches_jax():
    h, w = 20, 26
    arrs = random_splats(9, 300, h, w)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    ref = jax.jit(jras.composite, static_argnames=(
        "height", "width", "chunk", "with_depth"))(
        *map(jnp.asarray, arrs), height=h, width=w, bg=jnp.asarray(bg),
        chunk=128, with_depth=False, y_offset=6.0)
    got = rasterize.composite(*map(torch.as_tensor, arrs), height=h,
                              width=w, bg=torch.tensor(bg), chunk=128,
                              with_depth=False, y_offset=6.0)
    assert float(got.depth.abs().max()) == 0.0
    for name in ("rgb", "alpha", "depth"):
        _close(getattr(got, name), getattr(ref, name), 1e-5, 2e-5, name)
    # the offset moved the image: row r of the block is row r + 6
    full = rasterize.composite(*map(torch.as_tensor, arrs), height=h + 6,
                               width=w, chunk=128)
    _close(got.alpha, full.alpha[6:], 0, 1e-6)


# ---- the structured compositors -----------------------------------------

NC, HC, WC = 256, 32, 32  # composite_tiles against JAX's interpret mode
NAMES = ("mean2d", "conic", "log_opacity", "colors", "depth", "bg")


@pytest.fixture(scope="module")
def composite_case():
    """Splats, background, cotangents; JAX's interpret-mode composite_tiles
    and its gradients; the port's composite_tiles and its gradients."""
    arrs = random_splats(10, NC, HC, WC)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    rng = np.random.default_rng(11)
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((HC, WC, 3), (HC, WC), (HC, WC))]
    cot[2] *= 0.1

    def jloss(m, c, lo, col, dep, b):
        o = jrp.composite_tiles(m, c, lo, col, dep, jnp.asarray(arrs[5]),
                                height=HC, width=WC, bg=b, interpret=True)
        return (jnp.sum(o.rgb * cot[0]) + jnp.sum(o.alpha * cot[1])
                + jnp.sum(o.depth * cot[2])), o

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, arrs[:5]), jnp.asarray(bg))
    ts = [torch.tensor(a, requires_grad=True) for a in arrs[:5]]
    b = torch.tensor(bg, requires_grad=True)
    out = RP.composite_tiles(*ts[:5], torch.tensor(arrs[5]), HC, WC, b)
    loss = sum((o * torch.tensor(c)).sum()
               for o, c in zip((out.rgb, out.alpha, out.depth), cot))
    grads = torch.autograd.grad(loss, ts + [b])
    return arrs, bg, jout, jgrads, out, grads


def test_composite_tiles_matches_jax_interpret(composite_case):
    _, _, jout, _, out, _ = composite_case
    for name in ("rgb", "alpha", "depth"):
        _close(getattr(out, name), getattr(jout, name), 0, 5e-4, name,
               relative=False)


@pytest.mark.parametrize("name", NAMES)
def test_composite_tiles_grad_matches_jax_interpret(composite_case, name):
    _, _, _, jgrads, _, grads = composite_case
    i = NAMES.index(name)
    _close(grads[i], jgrads[i], 5e-3, 1e-5, name)


def test_composite_tiles_matches_jax_oracle(composite_case):
    arrs, bg, _, _, out, grads = composite_case
    ref = jax.jit(jras.composite, static_argnames=("height", "width"))(
        *map(jnp.asarray, arrs), height=HC, width=WC, bg=jnp.asarray(bg))
    for name in ("rgb", "alpha", "depth"):
        _close(getattr(out, name), getattr(ref, name), 0, 2e-5, name,
               relative=False)
    # masked rows: exactly zero gradient, never NaN
    invalid = torch.tensor(~arrs[5])
    for g in grads[:5]:
        assert torch.isfinite(g).all()
        assert float(g[invalid].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_structured_list_composites_match_jax(kind):
    """Structured composite_tiles_binned / composite_tiles_2d against JAX's
    (interpret mode) at the golden case's size, and bit-equal to their
    packed twins."""
    arrs = random_splats(12, 400, H, W)
    bg = np.array([0.1, 0.4, 0.7], np.float32)
    cols4 = [torch.tensor(arrs[i]) for i in (0, 1, 2, 5)]
    if kind == "binned":
        caps = dict(zip(("cap_factor", "d_levels"),
                        B.bin_requirements(*cols4, H, W)))
        jfn, fn, packed_fn = (jb.composite_tiles_binned,
                              B.composite_tiles_binned,
                              B.composite_tiles_binned_packed)
    else:
        caps = dict(zip(("cap_factor", "dy_levels", "dx_levels"),
                        T.tile_requirements(*cols4, H, W)))
        jfn, fn, packed_fn = (jt.composite_tiles_2d, T.composite_tiles_2d,
                              T.composite_tiles_2d_packed)
    ref = jax.jit(jfn, static_argnames=("height", "width", "interpret",
                                        *caps))(
        *map(jnp.asarray, arrs), height=H, width=W, bg=jnp.asarray(bg),
        interpret=True, **caps)
    ts = [torch.tensor(a) for a in arrs]
    got = fn(*ts, H, W, torch.tensor(bg), **caps)
    for name, atol in (("rgb", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        _close(getattr(got, name), getattr(ref, name), 0, atol, name,
               relative=False)
    twin = packed_fn(RP.pack_splats(*ts), H, W, torch.tensor(bg),
                     *caps.values())
    for name in ("rgb", "alpha", "depth"):
        assert torch.equal(getattr(got, name), getattr(twin, name)), name


# ---- utils ---------------------------------------------------------------


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(13 + deg)
    coeffs = rng.normal(size=(50, 25, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    ref = jax.jit(jsh.eval_sh, static_argnums=0)(deg, jnp.asarray(coeffs),
                                                 jnp.asarray(dirs))
    got = sh.eval_sh(deg, torch.tensor(coeffs), torch.tensor(dirs))
    _close(got, ref, 1e-5, 1e-6)


def test_sh_to_rgb_matches_jax():
    x = np.random.default_rng(18).normal(size=(40, 3)).astype(np.float32)
    _close(sh.sh_to_rgb(torch.tensor(x)), jsh.sh_to_rgb(jnp.asarray(x)),
           1e-6, 1e-7)
    _close(sh.rgb_to_sh(sh.sh_to_rgb(torch.tensor(x))), x, 1e-5, 1e-6)


def test_matrix_to_pose_matches_jax():
    rng = np.random.default_rng(19)
    qs = rng.normal(size=(6, 4))
    qs[0] = [-0.3, 0.6, 0.2, 0.7]  # w < 0 before the sign is fixed
    qs[1] = [0.0, 1.0, 0.0, 0.0]  # a half turn
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    M = np.tile(np.eye(4), (6, 1, 1))
    M[:, :3, :3] = np.asarray(jT.quat_to_rotmat(jnp.asarray(qs)))
    M[:, :3, 3] = rng.normal(size=(6, 3))
    M = M.astype(np.float32)
    ref = np.asarray(jax.jit(jT.matrix_to_pose)(jnp.asarray(M)))
    got = pT.matrix_to_pose(torch.tensor(M))
    _close(got, ref, 1e-6, 1e-6)
    assert (got[:, 0] >= 0).all()
    _close(got[0, :4], -qs[0], 1e-5, 1e-6)  # the same rotation, w >= 0


def test_gl_matrices_match_jax():
    rng = np.random.default_rng(20)
    R = np.asarray(jT.quat_to_rotmat(jnp.asarray([0.9, 0.1, -0.2, 0.3])))
    t = rng.normal(size=3)
    for kw in ({}, dict(translate=np.array([0.5, -1.0, 2.0]), scale=1.7)):
        want = jgraphics.get_world2view2(R, t, **kw)
        got = graphics.get_world2view2(R, t, **kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    want = jgraphics.get_projection_matrix(0.01, 100.0, 1.1, 0.8)
    got = graphics.get_projection_matrix(0.01, 100.0, 1.1, 0.8)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---- models ----------------------------------------------------------------


def _camera_pairs(hw=(H, W)):
    rng = np.random.default_rng(21)
    out = []
    for uid in range(3):
        q = rng.normal(size=4) * 0.1 + [1.0, 0, 0, 0]
        R = np.asarray(jT.quat_to_rotmat(jnp.asarray(q / np.linalg.norm(q))))
        t = rng.normal(size=3)
        kw = dict(fx=FX + uid, fy=FY, height=hw[0], width=hw[1], uid=uid,
                  image=rng.uniform(size=(*hw, 3)).astype(np.float32))
        out.append((jcam.Camera.create(R, t, **kw),
                    cam.Camera.create(R, t, **kw, device="cpu")))
    return out


def test_stack_cameras_matches_jax():
    pairs = _camera_pairs()
    jst = jcam.stack_cameras([j for j, _ in pairs])
    st = cam.stack_cameras([c for _, c in pairs])
    for name in ("pose", "fx", "fy", "cx", "cy", "image"):
        got, want = getattr(st, name), np.asarray(getattr(jst, name))
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert st.uid.dtype == torch.int64
    np.testing.assert_array_equal(st.uid.numpy(), np.asarray(jst.uid))
    assert (st.height, st.width, st.znear, st.zfar) == (
        jst.height, jst.width, jst.znear, jst.zfar) == (H, W, 0.01, 100.0)
    other = cam.Camera.create(np.eye(3), np.zeros(3), FX, FY, H + 1, W,
                              device="cpu")
    with pytest.raises(AssertionError, match="resolutions"):
        cam.stack_cameras([pairs[0][1], other])


def test_camera_helpers_match_jax():
    jc, c = _camera_pairs()[1]
    for name in ("w2c", "c2w", "center", "fovx", "fovy"):
        _close(getattr(c, name), getattr(jc, name), 1e-5, 1e-6, name)
    assert c.replace(uid=7).uid == 7 and c.uid == 1


def test_gaussian_model_helpers_match_jax():
    arrays, _ = _gaussians(seed=22, n=50)
    jg, g = _models(arrays)
    assert g.num_views == jg.num_views == 2
    for name in ("get_scaling", "get_opacity", "get_rotation",
                 "get_features"):
        _close(getattr(g, name)(), getattr(jg, name)(), 1e-6, 1e-7, name)
    _close(g.get_covariance(1.3), jg.get_covariance(1.3), 1e-5, 1e-7)
    assert g.replace(max_sh_degree=1).max_sh_degree == 1


# ---- eval and pipelines ----------------------------------------------------


def test_lpips_pair_and_grad_match_jax():
    jnet = jim.LpipsVGG.random(0)
    net = convert.lpips_from_numpy(
        [np.asarray(w) for w in jnet.conv_w],
        [np.asarray(b) for b in jnet.conv_b],
        [np.asarray(w) for w in jnet.lin_w], device="cpu")
    rng = np.random.default_rng(23)
    a, b = (rng.uniform(size=(32, 32, 3)).astype(np.float32)
            for _ in range(2))
    want, (jga, jgb) = jax.value_and_grad(
        lambda x, y: jim.lpips_pair(jnet, x, y), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    x = torch.tensor(a, requires_grad=True)
    y = torch.tensor(b, requires_grad=True)
    got = im.lpips_pair(net, x, y)
    ga, gb = torch.autograd.grad(got, [x, y])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    _close(ga, jga, 1e-3, 1e-5, "d/dx")
    _close(gb, jgb, 1e-3, 1e-5, "d/dy")
    no_grad = im.lpips(x, y, net)
    assert not no_grad.requires_grad and float(no_grad) == float(got.detach())


def test_add_opt_group_defaults_match_jax():
    jp, p = ArgumentParser(), ArgumentParser()
    jconfig.add_opt_group(jp)
    config.add_opt_group(p)
    assert vars(p.parse_args([])) == vars(jp.parse_args([]))
    argv = ["--iterations", "7", "--position_lr_init", "0.5"]
    assert vars(p.parse_args(argv)) == vars(jp.parse_args(argv))


@pytest.mark.parametrize("name", PORT_CLIS)
def test_cli_help_says_nothing_is_unported(name):
    mod = importlib.import_module(f"instantsplat_tpu_torch.cli.{name}")
    text = mod.build_parser().format_help()
    assert "not ported" not in text.lower()
