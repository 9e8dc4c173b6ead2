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

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

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


def _packed_random(seed, n, h, w):
    arrs = _random_splats(seed, n, h, w)
    lo = np.where(arrs[5], arrs[2], -np.inf).astype(np.float32)
    return torch.tensor(np.concatenate(
        [arrs[0], arrs[1], lo[:, None], arrs[3], arrs[4][:, None]], 1)), \
        torch.tensor(arrs[5])


def _contributing_pairs(packed, h, w):
    """(pixel x, pixel y, splat) of every pair with alpha >= 1/255."""
    px, py = rasterize.pixel_coords(h, w, "cpu")
    dx = px[:, None] - packed[None, :, 0]
    dy = py[:, None] - packed[None, :, 1]
    power = (-0.5 * (packed[None, :, 2] * dx * dx + packed[None, :, 4] * dy
                     * dy) - packed[None, :, 3] * dx * dy)
    alpha = torch.clamp(torch.exp(power + packed[None, :, 5]), max=0.99)
    hit = (power <= 0) & (alpha >= rasterize.ALPHA_EPS)
    pix, spl = torch.nonzero(hit, as_tuple=True)
    return px[pix].int(), py[pix].int(), spl


def test_splat_rects_cover_every_contributor():
    """Every (pixel, splat) pair with alpha >= 1/255 lies inside the
    splat's tile rectangle, and in a block of the tile that the splat's
    block mask marks."""
    h, w = 45, 70
    packed, valid = _packed_random(11, 600, h, w)
    rect = RP.splat_rects(packed, h, w)
    assert rect.dtype == torch.int32 and rect.shape == (600, 4)
    x, y, spl = _contributing_pairs(packed, h, w)
    assert len(spl) > 1000
    tx, ty = x // RP.TILE, y // RP.TILE
    r = rect[spl]
    assert bool(((tx >= r[:, 0]) & (tx <= r[:, 1]) & (ty >= r[:, 2])
                 & (ty <= r[:, 3])).all())
    blocks = RP.block_masks(packed[spl], tx, ty)
    bit = (y % RP.TILE) // RP.BLOCK_H * 2 + (x % RP.TILE) // RP.BLOCK_W
    assert bool(((blocks >> bit) & 1).bool().all())
    # the block mask is a real cull: under 3/4 of the covered tiles' blocks
    j, ctx, cty = RP.covered_tiles(rect, h, w)
    marked = RP.block_masks(packed[j], ctx, cty)
    n_marked = sum(int(((marked >> b) & 1).sum()) for b in range(8))
    assert 0 < n_marked < 6 * len(j)
    # invalid rows get an empty rectangle
    dead = rect[~valid]
    assert bool((dead[:, 1] < dead[:, 0]).all())


def _scan_cases(golden_case):
    """(packed, h, w) at the golden-case shape and at a ragged one with
    invalid rows and N no multiple of the group size."""
    arrays, _, cam = golden_case
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=2)
    with torch.no_grad():
        packed, _ = prepare_packed_splats(g, cam.pose, cam.fx, cam.fy,
                                          cam.cx, cam.cy, 1.0, 2, 48, 64)
    ragged, valid = _packed_random(13, 1100, 45, 70)
    assert 1100 % RP.GROUP and not bool(valid.all())
    return {"golden": (packed, 48, 64), "ragged": (ragged, 45, 70)}


@pytest.mark.parametrize("case", ["golden", "ragged"])
def test_packed_rects_round_trip(golden_case, case):
    """The kernels' int16 rectangles (8 bytes a splat) hold what
    splat_rects computes, empty rectangles included."""
    packed, h, w = _scan_cases(golden_case)[case]
    scan = RP.scan_plain(packed, h, w)
    rect = RP.splat_rects(packed, h, w)
    assert scan.rect.dtype == torch.int16
    assert scan.rect.is_contiguous() and scan.rect.element_size() * 4 == 8
    n = packed.shape[0]
    assert scan.rect.shape == (-(-n // RP.WORD_SPLATS) * RP.WORD_SPLATS, 4)
    assert torch.equal(RP.unpack_rects(scan.rect[:n]), rect)
    assert torch.equal(RP.pack_rects(rect), scan.rect[:n])
    dead = torch.cat([rect[:, 1] < rect[:, 0],
                      torch.ones(len(scan.rect) - n, dtype=torch.bool)])
    if case == "ragged":
        assert bool(dead[:n].any())
    assert bool((scan.rect[dead] == torch.tensor(
        [32767, -1, 32767, -1], dtype=torch.int16)).all())


@pytest.mark.parametrize("case", ["golden", "ragged"])
def test_group_tile_mask_marks_every_covering_group(golden_case, case):
    """The scan's coarse mask marks exactly the (group, tile) pairs in
    which some splat's rectangle covers the tile, so a tile that reads
    marked groups only drops nothing."""
    packed, h, w = _scan_cases(golden_case)[case]
    n = packed.shape[0]
    scan = RP.scan_plain(packed, h, w)
    n_tx, n_ty = -(-w // RP.TILE), -(-h // RP.TILE)
    n_words = -(-n // RP.WORD_SPLATS)
    assert scan.mask.dtype == torch.int32
    assert scan.mask.shape == (n_words, n_tx * n_ty)
    want = np.zeros((n_words * 32, n_tx * n_ty), bool)
    for j, (x0, x1, y0, y1) in enumerate(
            RP.splat_rects(packed, h, w).tolist()):
        for ty in range(y0, y1 + 1):  # empty for (_DEAD, -1)
            want[j // RP.GROUP, ty * n_tx + x0:ty * n_tx + x1 + 1] = True
    got = RP.mask_bits(scan.mask).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want[-(-n // RP.GROUP):].any()
    # and with it every contributing pair's (group, tile)
    x, y, spl = _contributing_pairs(packed, h, w)
    assert got[spl // RP.GROUP, (y // RP.TILE) * n_tx + x // RP.TILE].all()
    tests, entries, pairs = RP.scan_counts(packed, scan, h, w)
    assert tests == int(want.sum()) * RP.GROUP <= n_tx * n_ty * n_words * 1024
    assert entries * RP.TILE ** 2 >= pairs >= len(spl)


def _composite_through_scan(packed, scan, h, w):
    """The walk K1 makes, in plain torch: per tile the marked groups, of
    those the splats whose rectangle covers the tile, in order; per 8x4
    block those whose block mask marks it; composited by the plain
    version's scan."""
    n_tx = -(-w // RP.TILE)
    rect = RP.unpack_rects(scan.rect)
    groups = RP.mask_bits(scan.mask)
    acc = torch.zeros((4, h, w))
    tfin = torch.ones((h, w))
    lc = torch.full((h, w), -1, dtype=torch.int64)
    for ty in range(-(-h // RP.TILE)):
        for tx in range(n_tx):
            marked = torch.nonzero(groups[:, ty * n_tx + tx])[:, 0]
            j = (marked[:, None] * RP.GROUP + torch.arange(RP.GROUP)).reshape(-1)
            j = j[j < packed.shape[0]]
            r = rect[j]
            queue = j[(tx >= r[:, 0]) & (tx <= r[:, 1]) & (ty >= r[:, 2])
                      & (ty <= r[:, 3])]
            blocks = RP.block_masks(packed[queue],
                                    torch.full_like(queue, tx),
                                    torch.full_like(queue, ty))
            for b in range(8):
                y0 = ty * RP.TILE + b // 2 * RP.BLOCK_H
                x0 = tx * RP.TILE + b % 2 * RP.BLOCK_W
                y1, x1 = min(y0 + RP.BLOCK_H, h), min(x0 + RP.BLOCK_W, w)
                if y0 >= h or x0 >= w:
                    continue
                mine = queue[((blocks >> b) & 1).bool()]
                py, px = torch.meshgrid(
                    torch.arange(y0, y1, dtype=torch.float32),
                    torch.arange(x0, x1, dtype=torch.float32), indexing="ij")
                rgbd, logT, last = rasterize._scan_chunks(
                    packed[mine], mine, px.reshape(-1), py.reshape(-1), 64)
                shape = (y1 - y0, x1 - x0)
                acc[:, y0:y1, x0:x1] = rgbd.T.reshape(4, *shape)
                tfin[y0:y1, x0:x1] = torch.exp(logT).reshape(shape)
                lc[y0:y1, x0:x1] = last.reshape(shape)
    return acc, tfin, lc


@pytest.mark.parametrize("case", ["golden", "ragged"])
def test_scan_walk_composites_like_plain(golden_case, case):
    """Culling by coarse mask, rectangle and block mask leaves the image and
    the last-contributor index as the plain version computes them."""
    packed, h, w = _scan_cases(golden_case)[case]
    acc, tfin, lc = _composite_through_scan(
        packed, RP.scan_plain(packed, h, w), h, w)
    acc_p, tfin_p, lc_p = rasterize.composite_plain(packed, h, w)
    np.testing.assert_array_equal(lc.numpy(), lc_p.numpy())
    np.testing.assert_allclose(acc.numpy(), acc_p.numpy(), atol=2e-6)
    np.testing.assert_allclose(tfin.numpy(), tfin_p.numpy(), atol=2e-6)


def test_grad_scratch_returns_packed_columns():
    """K2 adds into a 16-byte-aligned [N, 12] scratch; what the wrapper
    hands to autograd is its first ten columns, usable as d(packed)."""
    rng = np.random.default_rng(3)
    grad = torch.tensor(rng.normal(size=(37, RP.NCOL)).astype(np.float32))
    scratch = torch.zeros((37, RP.GRAD_W))
    assert RP.GRAD_W * scratch.element_size() % 16 == 0
    scratch[:, :RP.NCOL] = grad
    out = RP.grad_columns(scratch)
    assert out.shape == (37, RP.NCOL) and torch.equal(out, grad)
    # a strided view is a valid cotangent for the [N, 10] packed array
    p = torch.zeros((37, RP.NCOL), requires_grad=True)
    (p * 2.0).backward(out)
    np.testing.assert_array_equal(p.grad.numpy(), 2.0 * grad.numpy())


def test_kernel_wrappers_reject_cpu_tensors():
    packed = torch.zeros((8, 10))
    scan = RP.scan_plain(packed, 16, 16)
    launches = (RP.KR.launches, RP.K1.launches, RP.K2.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RP.k1_rects(packed, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RP.k1_forward(packed, scan, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RP.k2_backward(packed, scan, torch.zeros(4, 16, 16),
                       torch.zeros(16, 16), torch.zeros(16, 16),
                       torch.zeros(16, 16, dtype=torch.int32))
    assert (RP.KR.launches, RP.K1.launches, RP.K2.launches) == launches


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
