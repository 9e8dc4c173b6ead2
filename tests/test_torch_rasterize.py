"""The port's compositor against the JAX package and the committed goldens.

- plain version (composite_plain / composite) against JAX
  rasterize.composite;
- the golden render case (tests/golden/render_case.npz) through the port's
  public render(), image, alpha, pose gradient and parameter-gradient
  checksums, at the oracle-golden tolerances of tests/test_golden.py;
- the same case against JAX composite_tiles_packed, which runs the Pallas
  kernels in interpret mode on the CPU, at the Pallas-golden tolerances;
- the capacity backend strings on the golden case;
- the CUDA wrapper's host-side pieces (tile rectangles, argument checks,
  backend names), which run here without a card.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.ops import rasterize as jras
from instantsplat_tpu.ops import rasterize_pallas as jrp
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import rasterize, rasterize_pallas as RP
from instantsplat_tpu_torch.ops import cuda_build
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.render.driver import prepare_packed_splats, render

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

from make_goldens import _cheq  # noqa: E402


def _random_splats(seed, n, height, width):
    """Depth-sorted separate arrays, as rasterize.composite takes them."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform([-5, -5], [width + 5, height + 5], (n, 2))
    s = rng.uniform(0.5, 4.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    a, c, b = s[:, 0] ** 2, s[:, 1] ** 2, rho * s[:, 0] * s[:, 1]
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], 1)
    log_op = np.log(rng.uniform(0.05, 0.99, n))
    colors = rng.uniform(size=(n, 3))
    depth = np.sort(rng.uniform(1, 10, n))
    valid = rng.uniform(size=n) > 0.1
    f = lambda x: x.astype(np.float32)  # noqa: E731
    return f(mean2d), f(conic), f(log_op), f(colors), f(depth), valid


@pytest.mark.parametrize("seed,n,hw", [(0, 300, (24, 40)), (1, 700, (37, 29))])
def test_plain_matches_jax_composite(seed, n, hw):
    h, w = hw
    arrs = _random_splats(seed, n, h, w)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    ref = jras.composite(*map(jnp.asarray, arrs), height=h, width=w,
                         bg=jnp.asarray(bg), chunk=128)
    got = rasterize.composite(*map(torch.as_tensor, arrs), height=h,
                              width=w, bg=torch.tensor(bg), chunk=128)
    for name in ("rgb", "alpha", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=2e-5, err_msg=name)


def test_plain_grad_matches_jax():
    h, w = 20, 26
    mean2d, conic, lo, col, dep, valid = _random_splats(3, 200, h, w)
    rng = np.random.default_rng(5)
    g_rgb = rng.normal(size=(h, w, 3)).astype(np.float32)
    g_a = rng.normal(size=(h, w)).astype(np.float32)

    def jl(m, c, l, cl, d):
        o = jras.composite(m, c, l, cl, d, jnp.asarray(valid), height=h,
                           width=w, chunk=64)
        return jnp.sum(o.rgb * g_rgb) + jnp.sum(o.alpha * g_a)

    ref = jax.grad(jl, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (
        mean2d, conic, lo, col, dep)))
    ts = [torch.tensor(x, requires_grad=True)
          for x in (mean2d, conic, lo, col, dep)]
    o = rasterize.composite(*ts, torch.tensor(valid), height=h, width=w,
                            chunk=64)
    loss = (o.rgb * torch.tensor(g_rgb)).sum() + (o.alpha * torch.tensor(
        g_a)).sum()
    got = torch.autograd.grad(loss, ts[:4])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())


def test_plain_lc_and_tfin():
    """lc is the last contributing sorted index; tfin never drops below the
    1e-4 stop."""
    h, w = 16, 16
    arrs = _random_splats(7, 400, h, w)
    lo = np.where(arrs[5], arrs[2], -np.inf).astype(np.float32)
    packed = torch.tensor(np.concatenate(
        [arrs[0], arrs[1], lo[:, None], arrs[3], arrs[4][:, None]], 1))
    acc, tfin, lc = rasterize.composite_plain(packed, h, w, chunk=32)
    assert acc.shape == (4, h, w) and tfin.shape == lc.shape == (h, w)
    assert float(tfin.min()) >= 1e-4 * (1 - 1e-5)
    # removing every splat after lc leaves the image unchanged
    last = int(lc.max())
    acc2, tfin2, lc2 = rasterize.composite_plain(packed[:last + 1], h, w,
                                                 chunk=32)
    np.testing.assert_allclose(acc2.numpy(), acc.numpy(), atol=1e-6)
    np.testing.assert_array_equal(lc2.numpy(), lc.numpy())


# ---- the golden render case -------------------------------------------


def _golden_inputs():
    """The inputs of scripts/make_goldens.py::build_render_case, drawn with
    its JAX code and handed over as numpy arrays."""
    from instantsplat_tpu.models.gaussians import GaussianModel as JG

    ks = jax.random.split(jax.random.PRNGKey(42), 3)
    n = 400
    pts = jax.random.normal(ks[0], (n, 3)) * 0.6 + jnp.array([0.0, 0.0, 4.0])
    cols = jax.random.uniform(ks[1], (n, 3))
    poses = jnp.tile(jnp.array([1.0, 0, 0, 0, 0, 0, 0]), (1, 1))
    g = JG.create_from_pcd(pts, cols, cam_poses=poses, max_sh_degree=2)
    g = g.replace(scaling=g.scaling + jnp.array([0.4, -0.3, 0.1]))
    target = np.asarray(jax.random.uniform(ks[2], (48, 64, 3)))
    return {f: np.asarray(getattr(g, f)) for f in PARAM_FIELDS}, target


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(REPO / "tests" / "golden" / "render_case.npz"))


@pytest.fixture(scope="module")
def golden_case():
    arrays, target = _golden_inputs()
    cam = Camera.create(np.eye(3), np.zeros(3), fx=70.0, fy=70.0, height=48,
                        width=64, uid=0, device="cpu")
    return arrays, target, cam


def _render_case(arrays, target, cam, backend):
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=2)
    out = render(g, cam, chunk=128, backend=backend)
    pose = cam.pose.clone().requires_grad_(True)
    ts = [getattr(g, f).clone().requires_grad_(True)
          for f in PARAM_FIELDS[:-1]]
    gg = GaussianModel(*ts, cam_poses=g.cam_poses, max_sh_degree=2)
    o = render(gg, cam, pose=pose, chunk=128, backend=backend)
    loss = torch.mean(torch.abs(o.render - torch.tensor(target)))
    grads = torch.autograd.grad(loss, [pose] + ts)
    sums = {}
    for f, gr in zip(PARAM_FIELDS[:-1], grads[1:]):
        w = np.asarray(_cheq(jnp.zeros(gr.shape, jnp.float32)), np.float64)
        sums[f"gsum_{f}"] = float(np.sum(gr.numpy().astype(np.float64) * w))
    return dict(image=out.render.detach().numpy(),
                alpha=out.alpha.detach().numpy(),
                pose_grad=grads[0].numpy().astype(np.float64), **sums)


@pytest.mark.parametrize("backend", ["oracle", "pallas", "auto"])
def test_render_matches_golden(golden, golden_case, backend):
    """Oracle-golden tolerances (tests/test_golden.py:39-50): the port's
    CPU path is the plain version for every dense backend name."""
    got = _render_case(*golden_case, backend)
    np.testing.assert_allclose(got["image"], golden["image"], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got["alpha"], golden["alpha"], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got["pose_grad"], golden["pose_grad"],
                               rtol=2e-4, atol=1e-7)
    for k, v in golden.items():
        if k.startswith("gsum_"):
            np.testing.assert_allclose(got[k], v, rtol=3e-4, atol=1e-6,
                                       err_msg=k)


def test_packed_render_matches_jax_pallas_interpret(golden_case):
    """The port's dense path against JAX composite_tiles_packed (Pallas
    kernels in interpret mode) on the golden case's packed splats, at the
    Pallas-golden tolerances (tests/test_golden.py:53-66)."""
    arrays, target, cam = golden_case
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=2)
    with torch.no_grad():
        packed, _ = prepare_packed_splats(g, cam.pose, cam.fx, cam.fy,
                                          cam.cx, cam.cy, 1.0, 2, 48, 64)
    pk = packed.numpy()
    bg = np.array([0.1, 0.3, 0.6], np.float32)

    def jl(p, b):
        o = jrp.composite_tiles_packed(p, height=48, width=64, bg=b,
                                       interpret=True)
        return jnp.mean(jnp.abs(o.rgb - target)) + 0.1 * jnp.mean(o.alpha), o

    (_, ref), (jgp, jgb) = jax.value_and_grad(jl, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(pk), jnp.asarray(bg))
    p = torch.tensor(pk, requires_grad=True)
    b = torch.tensor(bg, requires_grad=True)
    o = RP.composite_tiles_packed(p, 48, 64, bg=b)
    loss = torch.mean(torch.abs(o.rgb - torch.tensor(target))) + \
        0.1 * torch.mean(o.alpha)
    gp, gb = torch.autograd.grad(loss, [p, b])
    np.testing.assert_allclose(o.rgb.detach().numpy(), np.asarray(ref.rgb),
                               rtol=0, atol=5e-4)
    np.testing.assert_allclose(o.alpha.detach().numpy(),
                               np.asarray(ref.alpha), rtol=0, atol=5e-4)
    jgp = np.asarray(jgp)[:, :10]
    np.testing.assert_allclose(gp.numpy(), jgp, rtol=5e-3,
                               atol=1e-6 * np.abs(jgp).max())
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=5e-3,
                               atol=1e-6)


# ---- CUDA wrapper pieces that run without a card -----------------------


def test_splat_rects_cover_every_contributor():
    """Every (pixel, splat) pair with alpha >= 1/255 lies inside the
    splat's tile rectangle and its batch's rectangle."""
    h, w = 45, 70
    arrs = _random_splats(11, 600, h, w)
    lo = np.where(arrs[5], arrs[2], -np.inf).astype(np.float32)
    packed = torch.tensor(np.concatenate(
        [arrs[0], arrs[1], lo[:, None], arrs[3], arrs[4][:, None]], 1))
    rect, batch = RP.splat_rects(packed, h, w)
    assert rect.dtype == batch.dtype == torch.int32
    assert rect.shape == (600, 4) and batch.shape == (-(-600 // RP.BATCH), 4)
    px, py = rasterize.pixel_coords(h, w, "cpu")
    dx = px[:, None] - packed[None, :, 0]
    dy = py[:, None] - packed[None, :, 1]
    power = (-0.5 * (packed[None, :, 2] * dx * dx + packed[None, :, 4] * dy
                     * dy) - packed[None, :, 3] * dx * dy)
    alpha = torch.clamp(torch.exp(power + packed[None, :, 5]), max=0.99)
    hit = (power <= 0) & (alpha >= rasterize.ALPHA_EPS)
    pix, spl = torch.nonzero(hit, as_tuple=True)
    assert len(pix) > 1000
    tx = (px[pix] // RP.TILE).int()
    ty = (py[pix] // RP.TILE).int()
    for r in (rect[spl], batch[spl // RP.BATCH]):
        assert bool(((tx >= r[:, 0]) & (tx <= r[:, 1]) & (ty >= r[:, 2])
                     & (ty <= r[:, 3])).all())
    # invalid rows get an empty rectangle
    dead = rect[~torch.tensor(arrs[5])]
    assert bool((dead[:, 1] < dead[:, 0]).all())


def test_kernel_wrappers_reject_cpu_tensors():
    packed = torch.zeros((8, 10))
    rect, batch = RP.splat_rects(packed, 16, 16)
    launches = (RP.K1.launches, RP.K2.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RP.k1_forward(packed, rect, batch, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RP.k2_backward(packed, rect, batch, torch.zeros(4, 16, 16),
                       torch.zeros(16, 16), torch.zeros(16, 16),
                       torch.zeros(16, 16, dtype=torch.int32))
    assert (RP.K1.launches, RP.K2.launches) == launches


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_library_path_is_keyed_by_source_and_in_build():
    path = cuda_build.library_path("rasterize.cu")
    assert path.parts[-4:-2] == ("build", "instantsplat_tpu_torch")
    assert path.name == "librasterize.so"
    assert "--use_fast_math" not in cuda_build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


@pytest.mark.parametrize("backend", ["pallas-binned", "pallas-binned:4:8",
                                     "pallas-tiled:2:2:2", "binned-sized",
                                     "tiled-sized"])
def test_capacity_backends_render_golden(golden, golden_case, backend):
    """The capacity backends against the golden render case, at the
    oracle-golden tolerances. The golden splats are large for 64x48: the
    three fixed strings overflow there and the driver's guard renders them
    densely; "*-sized" are sized by the driver's view requirements and go
    through the lists (the plain version of K3/K4 or K5/K6 on the CPU)."""
    arrays, target, cam = golden_case
    if backend.endswith("-sized"):
        g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                          max_sh_degree=2)
        if backend == "binned-sized":
            caps = driver.binned_view_requirements(g, cam.pose, cam)
        else:
            caps = driver.tiled_view_requirements(g, cam.pose, cam)
        backend = ":".join(["pallas-" + backend.split("-")[0],
                            *map(str, caps)])
    got = _render_case(arrays, target, cam, backend)
    np.testing.assert_allclose(got["image"], golden["image"], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got["alpha"], golden["alpha"], rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(got["pose_grad"], golden["pose_grad"],
                               rtol=2e-4, atol=1e-7)
    for k, v in golden.items():
        if k.startswith("gsum_"):
            np.testing.assert_allclose(got[k], v, rtol=3e-4, atol=1e-6,
                                       err_msg=k)


def test_unknown_backend_raises(golden_case):
    arrays, _, cam = golden_case
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=2)
    with pytest.raises(ValueError, match="unknown"):
        render(g, cam, backend="nope")
