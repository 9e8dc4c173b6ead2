"""The port's capacity backends (binned K3/K4, tiled K5/K6) and stage 2's
backend="auto" against the JAX package, on the CPU.

- list construction (_build_bins/_build_tiles): the same slots, chunk map
  and overflow flag for the same capacities;
- sizing (bin_/tile_requirements, the driver's *_view_requirements),
  overflow flags and the driver's capacity_candidate: the same tuples,
  flags and strings;
- the driver's overflow guard: rate-limited, demotes with a warning, one
  list build a call;
- the trainer's auto probe and re-probe, with a rigged train step, and an
  auto run's loss curve against a fixed-dense run;
- mixed-aspect training against the JAX trainer (oracle backend).

The composites and their gradients against JAX's Pallas kernels in
interpret mode are in tests/test_torch_capacity_render.py.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.ops import rasterize_pallas_binned as jb
from instantsplat_tpu.ops import rasterize_pallas_tiled as jt
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as B
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as T
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines import trainer as tr
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.render import driver

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

# JAX's list construction and overflow flags, jitted as the JAX driver runs
# them (render/driver.py::_tiled_overflow_impl): eager dispatch of their
# many small ops costs seconds per call on the CPU
_jbuild_tiles = jax.jit(jt._build_tiles, static_argnums=tuple(range(4, 12)))
_jbuild_bins = jax.jit(jb._build_bins, static_argnums=(4, 5, 6, 7))
_jtile_overflow = jax.jit(jt.tile_overflow, static_argnums=(4, 5, 6, 7, 8))
_jbin_overflow = jax.jit(jb.bin_overflow, static_argnums=(4, 5, 6, 7))


def random_splats(seed, n, height, width, spread=4.0):
    """Depth-sorted separate float32 arrays (mean2d, conic, log_op, colors,
    depth) and a valid mask, drawn with numpy."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform([-5, -5], [width + 5, height + 5], (n, 2))
    s = rng.uniform(0.5, spread, (n, 2))
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


def packed_of(arrs):
    m, c, lo, col, dep, valid = arrs
    lo = np.where(valid, lo, -np.inf).astype(np.float32)
    return torch.tensor(np.concatenate([m, c, lo[:, None], col,
                                        dep[:, None]], 1))


def cols4(arrs, lib):
    m, c, lo, _, _, valid = arrs
    return tuple(lib(x) for x in (m, c, lo, valid))


def slot_array(lists, cap):
    """The port's lists laid out in the TPU's capacity-sized slot array."""
    out = np.full(cap, -1, np.int64)
    for st, k, ps in zip(lists.seg_start.tolist(), lists.seg_count.tolist(),
                         lists.slot_start.tolist()):
        out[ps:ps + k] = lists.order[st:st + k].numpy()
    return out


def assert_chunk_map(chunk_map, dead, lists, cap):
    """JAX's chunk -> segment map holds exactly the chunks of each list the
    port keeps: ceil(kept / 256) chunks from the list's slot position."""
    chunk_map = np.asarray(chunk_map)
    for s, (k, ps) in enumerate(zip(lists.seg_count.tolist(),
                                    lists.slot_start.tolist())):
        chunks = np.nonzero(chunk_map == s)[0]
        if k == 0:
            # JAX maps no chunk to an empty list (a list cut off entirely
            # by the capacity has no chunk inside it either)
            assert len(chunks) == 0, s
            continue
        n_ch = -(-k // 256)
        np.testing.assert_array_equal(chunks, ps // 256 + np.arange(n_ch))
    live = np.isin(chunk_map, np.arange(lists.seg_count.shape[0]))
    assert ((chunk_map == dead) | live).all()
    assert live.sum() == sum(-(-k // 256) for k in lists.seg_count.tolist())
    assert len(chunk_map) == cap // 256


@pytest.mark.parametrize("caps", [(None, None, None), (1, 1, 1), (8, 3, 2),
                                  (2, 6, 3)])
def test_build_tiles_matches_jax(caps):
    h, w = 45, 300  # 6 row blocks x 3 column buckets
    arrs = random_splats(0, 900, h, w, spread=9.0)
    lists, geom = T.tile_lists(packed_of(arrs), h, w, *caps)
    cap, dy, dx = T._caps(900, geom, *caps)
    j = _jbuild_tiles(*cols4(arrs, jnp.asarray), geom.n_rows * 8,
                      geom.n_cols * 128, cap, dy, dx, 8, 128, 256)
    np.testing.assert_array_equal(slot_array(lists, cap), np.asarray(j[0]))
    assert_chunk_map(j[1], geom.n_seg, lists, cap)
    assert bool(lists.overflow) == bool(j[3])


@pytest.mark.parametrize("caps", [(None, None), (1, 2), (2, 4), (6, 30)])
def test_build_bins_matches_jax(caps):
    h, w = 70, 60
    arrs = random_splats(1, 800, h, w, spread=9.0)
    lists, geom = B.bin_lists(packed_of(arrs), h, w, *caps)
    cap, dl = B._caps(800, geom, *caps)
    j = _jbuild_bins(*cols4(arrs, jnp.asarray), 0, geom.n_rows * 4, cap, dl)
    np.testing.assert_array_equal(slot_array(lists, cap), np.asarray(j[0]))
    assert_chunk_map(j[1], -1, lists, cap)
    assert bool(lists.overflow) == bool(j[2])


def test_build_lists_cover_every_contributor():
    """Sized lists hold every (pixel, splat) pair with alpha >= 1/255."""
    h, w = 40, 150
    arrs = random_splats(2, 500, h, w)
    packed = packed_of(arrs)
    req_t = T.tile_requirements(*cols4(arrs, torch.tensor), h, w)
    req_b = B.bin_requirements(*cols4(arrs, torch.tensor), h, w)
    from instantsplat_tpu_torch.ops.rasterize import ALPHA_EPS, pixel_coords

    px, py = pixel_coords(h, w, "cpu")
    dx = px[:, None] - packed[None, :, 0]
    dy = py[:, None] - packed[None, :, 1]
    power = (-0.5 * (packed[None, :, 2] * dx * dx + packed[None, :, 4] * dy
                     * dy) - packed[None, :, 3] * dx * dy)
    hit = (power <= 0) & (torch.exp(power + packed[None, :, 5]) >= ALPHA_EPS)
    pix, spl = torch.nonzero(hit, as_tuple=True)
    assert len(pix) > 1000
    for (lists, geom) in (T.tile_lists(packed, h, w, *req_t),
                          B.bin_lists(packed, h, w, *req_b)):
        assert not bool(lists.overflow)
        seg = (py[pix].long() // geom.seg_rows) * geom.n_cols + \
            px[pix].long() // geom.seg_w
        members = set()
        for s, (st, k) in enumerate(zip(lists.seg_start.tolist(),
                                        lists.seg_count.tolist())):
            members.update((s, int(g)) for g in lists.order[st:st + k])
        assert all((int(s), int(g)) in members for s, g in zip(seg, spl))


@pytest.mark.parametrize("seed,n,hw,spread", [
    (3, 600, (48, 64), 4.0), (4, 2000, (37, 150), 12.0),
    (5, 300, (600, 90), 30.0), (6, 50, (20, 20), 1.0)])
def test_requirements_match_jax(seed, n, hw, spread):
    """The (600, 90) case spans two of the TPU's 512-row strips."""
    h, w = hw
    arrs = random_splats(seed, n, h, w, spread)
    tc, jc = cols4(arrs, torch.tensor), cols4(arrs, jnp.asarray)
    assert B.bin_requirements(*tc, h, w) == jb.bin_requirements(*jc, h, w)
    assert T.tile_requirements(*tc, h, w) == jt.tile_requirements(*jc, h, w)
    cf, dl = B._bin_requirements_impl(*tc, h, w)
    jcf, jdl = jb._bin_requirements_impl(*jc, h, w)
    assert float(cf) == float(jcf) and dl == int(jdl)
    raw = T._tile_requirements_impl(*tc, h, w)
    jraw = jt._tile_requirements_impl(*jc, h, w)
    assert float(raw[0]) == float(jraw[0]) and raw[1:] == tuple(
        int(x) for x in jraw[1:])


@pytest.mark.parametrize("caps", [(None, None, None, None, None),
                                  (1, 2, 1, 1, 1), (4, 8, 3, 2, 2),
                                  (6, 20, 8, 8, 3)])
def test_overflow_flags_match_jax(caps):
    h, w = 48, 200
    arrs = random_splats(7, 1200, h, w, spread=7.0)
    tc, jc = cols4(arrs, torch.tensor), cols4(arrs, jnp.asarray)
    bcf, dl, tcf, dy, dx = caps
    assert bool(B.bin_overflow(*tc, h, w, bcf, dl)) == bool(
        _jbin_overflow(*jc, h, w, bcf, dl))
    assert bool(T.tile_overflow(*tc, h, w, tcf, dy, dx)) == bool(
        _jtile_overflow(*jc, h, w, tcf, dy, dx))


@pytest.mark.parametrize("old,new", [
    ("pallas-tiled:4:3:2", "pallas-tiled:4:4:2"),
    ("pallas-tiled:5:3:2", "pallas-tiled:4:3:2"),
    ("pallas-binned:3:4", "pallas-tiled:3:4:2"),
    ("pallas-binned:3:9", "pallas-binned:4:9"),
    ("pallas-binned", "pallas-binned")])
def test_binned_caps_grew_matches_jax(old, new):
    import instantsplat_tpu.pipelines.trainer as jtr

    assert driver.capacities_grew(old, new) == jtr._binned_caps_grew(old,
                                                                     new)


def test_tiled_key_space_guard():
    packed = torch.zeros((40_000, 10))
    with pytest.raises(ValueError, match="key space"):
        T.composite_tiles_2d_packed(packed, 8192, 8192)


def test_tiled_empty_tiles_background():
    """Tiles no splat reaches come out as pure background."""
    h, w, n = 64, 300, 40
    rng = np.random.default_rng(11)
    packed = torch.zeros((n, 10))
    packed[:, :2] = torch.tensor(rng.uniform(5.0, 20.0, (n, 2)),
                                 dtype=torch.float32)
    packed[:, 2], packed[:, 4] = 0.5, 0.5
    packed[:, 5] = float(np.log(0.9))
    packed[:, 6:9] = 0.7
    packed[:, 9] = torch.linspace(1.0, 2.0, n)
    bg = torch.tensor([0.25, 0.5, 0.75])
    for out in (T.composite_tiles_2d_packed(packed, h, w, bg),
                B.composite_tiles_binned_packed(packed, h, w, bg)):
        assert torch.allclose(out.rgb[40:, 200:], bg, atol=1e-6)
        assert float(out.alpha[40:, 200:].max()) == 0.0
        assert float(out.rgb[5:20, 5:20].mean()) > 0.4


# ---- scenes (Gaussians + cameras) -------------------------------------


def _look_at(eye):
    fwd = -np.asarray(eye, np.float64)
    fwd /= np.linalg.norm(fwd)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return R, -R @ np.asarray(eye)


def grid_scene(giant=False):
    """The 3000-splat grid scene of tests/test_train_e2e.py (a plane of
    small splats at depth 6 seen by a 512x384 camera), as arrays; `giant`
    scales every splat by 256."""
    rng = np.random.default_rng(0)
    n = 3000
    side = int(np.ceil(np.sqrt(n)))
    gy, gx = np.meshgrid(np.arange(side), np.arange(side))
    g = (np.stack([gx, gy], -1).reshape(-1, 2)[:n] / side - 0.5) * 3.0
    pts = np.concatenate(
        [g, 6.0 + 0.05 * rng.standard_normal((n, 1))], 1).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    return pts, cols, giant


def test_binned_candidate_matches_jax_on_grid_scene():
    from instantsplat_tpu.models.camera import Camera as JCam
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    import instantsplat_tpu.pipelines.trainer as jtr

    pts, cols, _ = grid_scene()
    poses = np.array([[1.0, 0, 0, 0, 0, 0, 0]], np.float32)
    jp = JG.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols),
                            cam_poses=jnp.asarray(poses), max_sh_degree=0)
    jp = jp.replace(opacity=jnp.full_like(jp.opacity, 2.0))
    jcam = JCam.create(np.eye(3), np.zeros(3), fx=300.0, fy=300.0,
                       height=384, width=512, uid=0)
    arrays = {f: np.asarray(getattr(jp, f)) for f in PARAM_FIELDS}
    tp = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                       max_sh_degree=0)
    cam = Camera.create(np.eye(3), np.zeros(3), fx=300.0, fy=300.0,
                        height=384, width=512, uid=0, device="cpu")
    cand = driver.capacity_candidate(tp, cam)
    assert cand == jtr._binned_candidate(jp, jcam)
    assert cand.startswith("pallas-tiled:"), cand
    # giant splats: tile levels pass the product cap -> the binned string
    jbig = jp.replace(scaling=jp.scaling + float(np.log(256.0)))
    tp.scaling += float(np.log(np.float32(256.0)))
    np.testing.assert_array_equal(tp.scaling.numpy(),
                                  np.asarray(jbig.scaling))
    cand_big = driver.capacity_candidate(tp, cam)
    assert cand_big == jtr._binned_candidate(jbig, jcam)
    assert cand_big is None or cand_big.startswith("pallas-binned:")


def test_view_requirements_match_jax():
    """driver.*_view_requirements (the sizing auto uses) on a flat 2048-
    point scene, and with scale_modifier 8."""
    from instantsplat_tpu.models.camera import Camera as JCam
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    from instantsplat_tpu.render import driver as jdrv

    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(2048, 3)) * [2.0, 0.2, 0.01]
           + [0.0, 0.0, 3.0]).astype(np.float32)
    cols = rng.uniform(size=(2048, 3)).astype(np.float32)
    poses = np.array([[1.0, 0, 0, 0, 0, 0, 0]], np.float32)
    jg = JG.create_from_pcd(jnp.asarray(pts), jnp.asarray(cols),
                            cam_poses=jnp.asarray(poses), max_sh_degree=0)
    tg = GaussianModel(**{f: torch.tensor(np.asarray(getattr(jg, f)))
                          for f in PARAM_FIELDS}, max_sh_degree=0)
    jcam = JCam.create(np.eye(3), np.zeros(3), fx=60.0, fy=60.0, height=32,
                       width=128, uid=0)
    cam = Camera.create(np.eye(3), np.zeros(3), fx=60.0, fy=60.0, height=32,
                        width=128, uid=0, device="cpu")
    for sm in (1.0, 8.0):
        assert driver.binned_view_requirements(
            tg, tg.get_pose(0), cam, sm) == jdrv.binned_view_requirements(
            jg, jg.get_pose(0), jcam, sm)
        assert driver.tiled_view_requirements(
            tg, tg.get_pose(0), cam, sm) == jdrv.tiled_view_requirements(
            jg, jg.get_pose(0), jcam, sm)


# ---- the driver's overflow guard ----------------------------------------


@pytest.fixture
def fresh_guard():
    driver.reset_overflow_guard()
    yield
    driver.reset_overflow_guard()


def _small_scene(seed=0, n=150, shapes=((24, 32),) * 3, sh=1):
    """Gaussians (non-degenerate: anisotropic scales, random rotations and
    opacities) and cameras with smooth target images, as numpy arrays and
    camera specs both packages can be built from."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.6
    cols = rng.uniform(0.1, 0.9, (n, 3))
    specs, w2cs = [], []
    for i, ((h, w), ang) in enumerate(zip(
            shapes, np.linspace(-0.3, 0.3, len(shapes)))):
        R, t = _look_at((4 * np.sin(ang), 0.3, -4 * np.cos(ang)))
        yy, xx = np.mgrid[0:h, 0:w] / 6.0
        img = np.stack([np.sin(xx + i), np.cos(yy - i), np.sin(xx * yy)], -1)
        specs.append((R, t, h, w, (img * 0.4 + 0.5).astype(np.float32), i))
        M = np.eye(4)
        M[:3, :3], M[:3, 3] = R, t
        w2cs.append(M)
    g = GaussianModel.create_from_pcd(
        pts, cols, max_sh_degree=sh, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(w2cs))
    arrays = {f: getattr(g, f).numpy() for f in PARAM_FIELDS}
    arrays["scaling"] = arrays["scaling"] + rng.normal(size=(n, 3)) * 0.3
    arrays["rotation"] = rng.normal(size=(n, 4))
    arrays["opacity"] = rng.normal(size=(n, 1)) + 1.0
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}, specs


def _port(arrays, specs, sh=1):
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=sh)
    cams = [Camera.create(R, t, fx=30.0, fy=30.0, height=h, width=w,
                          image=img, uid=uid, device="cpu")
            for R, t, h, w, img, uid in specs]
    return g, cams


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_guard_demotes_with_warning(fresh_guard, caplog, kind):
    arrays, specs = _small_scene()
    g, cams = _port(arrays, specs)
    backend = {"binned": "pallas-binned:1:1",
               "tiled": "pallas-tiled:1:1:1"}[kind]
    with caplog.at_level(logging.WARNING):
        out = driver.render(g, cams[0], backend=backend)
        driver.render(g, cams[0], backend=backend)
    warned = [r for r in caplog.records if "auto-switching" in r.message]
    assert len(warned) == 1, caplog.text
    assert len(driver.demoted()) == 1
    ref = driver.render(g, cams[0], backend="pallas")
    torch.testing.assert_close(out.render, ref.render)


def test_guard_checks_at_its_rate(fresh_guard, monkeypatch):
    """The flag is read on a signature's first call and then every
    _BINNED_CHECK_EVERY calls; a sized string is never demoted."""
    arrays, specs = _small_scene()
    g, cams = _port(arrays, specs)
    calls = []
    real = T.tile_lists

    class Read:
        """An overflow flag whose host reads are counted."""

        def __init__(self, flag):
            self.flag = flag

        def __bool__(self):
            calls.append(1)
            return bool(self.flag)

    def counted(*a, **k):
        lists, geom = real(*a, **k)
        return lists._replace(overflow=Read(lists.overflow)), geom

    monkeypatch.setattr(T, "tile_lists", counted)
    monkeypatch.setattr(driver, "_BINNED_CHECK_EVERY", 3)
    cf, dy, dx = driver.tiled_view_requirements(g, g.get_pose(0), cams[0])
    with torch.no_grad():
        for _ in range(7):
            driver.render(g, cams[0], backend=f"pallas-tiled:{cf}:{dy}:{dx}")
    assert len(calls) == 3 and not driver.demoted()


@pytest.mark.parametrize("backend", ["pallas-binned", "pallas-tiled"])
def test_checked_call_builds_its_lists_once(fresh_guard, monkeypatch,
                                            backend):
    """A call outside a block whose overflow flag the guard reads (a
    signature's first) builds its lists once, and composites those."""
    arrays, specs = _small_scene()
    g, cams = _port(arrays, specs)
    module = B if backend == "pallas-binned" else T
    builds = []
    real = module.build_lists
    monkeypatch.setattr(module, "build_lists",
                        lambda *a: builds.append(1) or real(*a))
    with torch.no_grad():
        out = driver.render(g, cams[0], backend=backend)
    assert len(builds) == 1 and not driver.demoted()
    with torch.no_grad():
        ref = driver.render(g, cams[0], backend="pallas")
    torch.testing.assert_close(out.render, ref.render)


# ---- the trainer's auto probe -----------------------------------------


def _rig(monkeypatch, slow):
    """Record (iteration, backend) of every train step, and make the probe's
    clock a fake one that each step advances by 1 s, or 10 s when
    slow(backend). The steps are those of the scanned blocks
    (make_train_scan, TrainerConfig.scan's default) and of the eager
    loop (train_step)."""
    seen = []
    now = [0.0]
    real = tr.train_step
    real_scan = tr.make_train_scan

    def step(params, cam, opt, state, it, sh, bg, lam, backend, chunk,
             **kw):
        seen.append((it, backend))
        now[0] += 10.0 if slow(backend) else 1.0
        return real(params, cam, opt, state, it, sh, bg, lam, backend, chunk,
                    **kw)

    def scan(optimizer, cameras, bg, lam, backend, chunk, **kw):
        block = real_scan(optimizer, cameras, bg, lam, backend, chunk, **kw)

        def rigged(params, state, views, iterations, sh):
            for it in iterations:
                seen.append((it, backend))
                now[0] += 10.0 if slow(backend) else 1.0
            return block(params, state, views, iterations, sh)

        return rigged

    monkeypatch.setattr(tr, "train_step", step)
    monkeypatch.setattr(tr, "make_train_scan", scan)
    monkeypatch.setattr(tr, "_clock", lambda: now[0])
    return seen


def _is_dense(backend):
    return backend == "pallas"


@pytest.mark.parametrize("slow", ["dense", "candidate"])
def test_auto_probe_keeps_the_faster(monkeypatch, capsys, fresh_guard,
                                     slow):
    """Blocks 0-1 (probe = min(10, log_every) iterations each) run dense,
    blocks 2-3 the candidate; the second of each is timed and the faster
    backend runs every later iteration (JAX trainer.py:578-600)."""
    arrays, specs = _small_scene(n=60)
    g, cams = _port(arrays, specs)
    cand = driver.capacity_candidate(g, cams[0])
    assert cand is not None and cand.startswith("pallas-tiled:")
    seen = _rig(monkeypatch, lambda b: _is_dense(b) == (slow == "dense"))
    train_joint(g, cams, OptimizationConfig(optim_pose=True),
                TrainerConfig(iterations=10, log_every=2, backend="auto"))
    out = capsys.readouterr().out
    names = [b for _, b in seen]
    assert [it for it, _ in seen] == list(range(1, 11))
    assert names[:4] == ["pallas"] * 4 and names[4:8] == [cand] * 4
    expect, word = (cand, "binned") if slow == "dense" else ("pallas",
                                                             "dense")
    assert names[8:] == [expect] * 2
    assert f"[train] backend auto: {word} (" in out, out


def test_traced_block_does_not_sway_the_probe(monkeypatch, capsys,
                                               fresh_guard, tmp_path):
    """profile_dir traces block 1, the dense block auto times: the trace's
    start, stop and export (here 1000 clock units each) stay out of its
    time, so the probe keeps the same backend as an untraced run."""
    import contextlib

    from instantsplat_tpu_torch.utils import profiling

    arrays, specs = _small_scene(n=60)
    real = profiling.profile_trace
    runs = {}
    for traced in (False, True):
        with monkeypatch.context() as mp:
            g, cams = _port(arrays, specs)
            seen = _rig(mp, lambda b: not _is_dense(b))
            rigged, late = tr._clock, [0.0]
            mp.setattr(tr, "_clock", lambda: rigged() + late[0])

            @contextlib.contextmanager
            def slow_trace(logdir, enabled=True):
                cost = 1000.0 if enabled and logdir else 0.0
                late[0] += cost
                with real(logdir, enabled):
                    yield
                late[0] += cost

            mp.setattr(profiling, "profile_trace", slow_trace)
            logdir = str(tmp_path / "prof") if traced else None
            train_joint(g, cams, OptimizationConfig(optim_pose=True),
                        TrainerConfig(iterations=10, log_every=2,
                                      backend="auto", profile_dir=logdir))
        runs[traced] = [b for _, b in seen]
        assert "[train] backend auto: dense (" in capsys.readouterr().out
    assert runs[True] == runs[False]
    assert runs[True][8:] == ["pallas"] * 2
    assert len(list((tmp_path / "prof").glob("*.pt.trace.json"))) == 1


def test_reprobe_resizes_then_demotes(monkeypatch, capsys, fresh_guard):
    """Every _REPROBE_EVERY iterations the capacity side is re-sized
    against the live scene (a grown requirement is adopted), and a
    candidate that no longer fits demotes it to dense (JAX trainer.py:
    482-577)."""
    arrays, specs = _small_scene(n=60)
    g, cams = _port(arrays, specs)
    monkeypatch.setattr(tr, "_REPROBE_EVERY", 6)
    seen = _rig(monkeypatch, _is_dense)
    base = driver.capacity_candidate(g, cams[0])
    kind, cf, *levels = base.split(":")
    grown = ":".join([kind, str(int(cf) + 1), *levels])
    answers = iter([base, grown, None, None])
    monkeypatch.setattr(driver, "capacity_candidate",
                        lambda params, camera: next(answers))
    train_joint(g, cams, OptimizationConfig(optim_pose=True),
                TrainerConfig(iterations=24, log_every=2, backend="auto"))
    out = capsys.readouterr().out
    names = dict(seen)
    # probe: dense 1-4, the candidate 5-8 and wins (dense is slowed); the
    # re-probe at iteration 9 resizes it, then times it (9-10) and dense
    # (11-12), which stays slower
    assert [names[i] for i in range(1, 9)] == ["pallas"] * 4 + [base] * 4
    assert f"resized {base} -> {grown} at iter 9" in out, out
    assert [names[i] for i in range(9, 17)] == [grown] * 2 + \
        ["pallas"] * 2 + [grown] * 4
    # the re-probe at 17 finds no fitting candidate: demoted to dense; the
    # one at 23 finds none either and leaves dense in place
    assert "demoting binned at iter 17" in out, out
    assert all(names[i] == "pallas" for i in range(17, 25))


def test_auto_loss_curve_equals_dense(fresh_guard):
    """Same start, seed and views: an auto run (whichever backend wins)
    and a fixed-dense run give the same losses; the capacity backend's
    plain version differs from the dense one only in how its sums are
    grouped."""
    arrays, specs = _small_scene(seed=3)
    hist = {}
    for backend in ("auto", "pallas"):
        g, cams = _port(arrays, specs)
        _, _, h = train_joint(g, cams, OptimizationConfig(optim_pose=True),
                              TrainerConfig(iterations=16, log_every=2,
                                            backend=backend))
        hist[backend] = h
    assert [i for i, _ in hist["auto"]] == [i for i, _ in hist["pallas"]]
    np.testing.assert_allclose([m["loss"] for _, m in hist["auto"]],
                               [m["loss"] for _, m in hist["pallas"]],
                               rtol=1e-4)


def test_mixed_shapes_match_jax():
    """Two image shapes, oracle backend: each view renders at its own shape
    and the loss curve follows the JAX trainer's (rtol 1e-4, as the uniform
    scene's test in tests/test_torch_train.py)."""
    from instantsplat_tpu.models.camera import Camera as JCam
    from instantsplat_tpu.models.gaussians import GaussianModel as JG
    from instantsplat_tpu.opt.gaussian_opt import (
        OptimizationConfig as JOpt)
    from instantsplat_tpu.pipelines.trainer import (
        TrainerConfig as JCfg, train_joint as jtrain)

    arrays, specs = _small_scene(seed=4, shapes=((24, 32), (32, 24),
                                                 (24, 32)))
    g, cams = _port(arrays, specs)
    jg = JG(**{f: jnp.asarray(v) for f, v in arrays.items()},
            max_sh_degree=1)
    jcams = [JCam.create(R, t, fx=30.0, fy=30.0, height=h, width=w,
                         image=img, uid=uid)
             for R, t, h, w, img, uid in specs]
    kw = dict(iterations=6, log_every=1, backend="oracle", chunk=64)
    _, _, th = train_joint(g, cams, OptimizationConfig(optim_pose=True),
                           TrainerConfig(**kw))
    _, _, jh = jtrain(jg, jcams, JOpt(optim_pose=True), JCfg(**kw))
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(1, 7))
    np.testing.assert_allclose([m["loss"] for _, m in th],
                               [m["loss"] for _, m in jh], rtol=1e-4)


def test_mixed_shapes_auto_resolves_dense(monkeypatch):
    arrays, specs = _small_scene(shapes=((24, 32), (32, 24)))
    g, cams = _port(arrays, specs)
    seen = _rig(monkeypatch, lambda b: False)
    train_joint(g, cams, OptimizationConfig(),
                TrainerConfig(iterations=4, log_every=2, backend="auto"))
    assert {b for _, b in seen} == {"pallas"}
