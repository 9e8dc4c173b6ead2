"""The port's pre-training data (train_dust3r/datasets.py, loaders.py,
16-bit PNG in data/png.py) and `cli.pretrain` against the JAX package's
on the CPU, on the same seeded inputs:

- the view transforms (crop, rescale, crop-resize with portrait,
  near-square and aug_crop draws), `color_jitter` and its HSV
  conversions, GT correspondences: equal to JAX's (the HSV copy equal to
  matplotlib's);
- `PosedMultiViewDataset.batches` sequentially, with `num_workers=4` and
  with `shard`: arrays equal to JAX's; the dataset arithmetic;
  `prefetch_iter`'s order, errors and release on abandonment;
- each of the nine loaders on JAX's own writer's fixture: batches equal
  to JAX's; the port's writers' files read the same by JAX's loaders;
- 16-bit greyscale PNG read and written by the port, equal to Pillow's
  samples both ways;
- `cli.pretrain --tiny --device cpu` against JAX's `cli.pretrain --tiny`
  on one synthetic posed scene (plain float32 steps): the same history
  and final parameters within 1e-4.
"""

import threading
import time

import numpy as np
import PIL.Image
import pytest
import torch

from instantsplat_tpu.train_dust3r import datasets as jd
from instantsplat_tpu.train_dust3r import loaders as jl
from instantsplat_tpu_torch.data import png
from instantsplat_tpu_torch.train_dust3r import datasets as td
from instantsplat_tpu_torch.train_dust3r import loaders as tl

torch.set_num_threads(2)


def assert_batches_equal(got, want, what=""):
    assert len(got) == len(want), what
    for gb, wb in zip(got, want):
        _assert_tree_equal(gb, wb, what)


def _assert_tree_equal(g, w, what):
    if isinstance(w, dict):
        assert g.keys() == w.keys(), what
        for k in w:
            _assert_tree_equal(g[k], w[k], f"{what}/{k}")
        return
    g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
    w = np.asarray(w)
    assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def take(gen, n):
    out = []
    for b in gen:
        out.append(b)
        if len(out) == n:
            break
    return out


def view_case(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    depth = (rng.random((h, w)) * 3 + 1).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0
    K = np.array([[w * 0.9, 0, w / 2 + 1.3], [0, w * 0.9, h / 2 - 0.7],
                  [0, 0, 1]], np.float32)
    return img, depth, K


def assert_views_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hw,res,aug", [
    ((40, 60), (32, 24), 0),   # landscape, Lanczos down
    ((40, 60), (48, 32), 5),   # aug_crop draws, bicubic up
    ((64, 40), (32, 24), 0),   # portrait: the target turns
    ((40, 42), (32, 24), 3),   # near-square: a coin flip turns it
    ((32, 48), (48, 32), 0),   # already the size: no Pillow needed
])
def test_crop_resize_view_matches_jax(hw, res, aug):
    img, depth, K = view_case(*hw)
    for seed in range(3):
        got = td.crop_resize_view(img, depth, K, res,
                                  rng=np.random.default_rng(seed),
                                  aug_crop=aug)
        want = jd.crop_resize_view(img, depth, K, res,
                                   rng=np.random.default_rng(seed),
                                   aug_crop=aug)
        assert_views_equal(got, want)


def test_rescale_crop_and_camera_matrix_match_jax():
    img, depth, K = view_case(30, 50, 1)
    for out in ((50, 30), (25, 15), (70, 40)):
        assert_views_equal(td.rescale_view(img, depth, K, out),
                           jd.rescale_view(img, depth, K, out))
    u8 = (img * 255).astype(np.uint8)
    assert_views_equal(td.rescale_view(u8, depth, K, (25, 15)),
                       jd.rescale_view(u8, depth, K, (25, 15)))
    assert_views_equal(td.crop_view(img, depth, K, (3, 2, 40, 27)),
                       jd.crop_view(img, depth, K, (3, 2, 40, 27)))
    np.testing.assert_array_equal(
        td.camera_matrix_of_crop(K, (50, 30), (40, 20), scaling=1.5,
                                 offset_factor=0.3),
        jd.camera_matrix_of_crop(K, (50, 30), (40, 20), scaling=1.5,
                                 offset_factor=0.3))


def test_same_size_rescale_needs_no_pillow(monkeypatch):
    """At the size the view already has, rescale_view copies; only a real
    resize reaches Pillow, which raises a clear error when absent."""
    import instantsplat_tpu_torch.train_dust3r.datasets as mod

    def no_pillow(what):
        raise RuntimeError(f"{what} needs Pillow")

    monkeypatch.setattr(mod, "_pillow", no_pillow)
    img, depth, K = view_case(32, 48, 2)
    got = td.rescale_view(img, depth, K, (48, 32))
    assert_views_equal(got, jd.rescale_view(img, depth, K, (48, 32)))
    with pytest.raises(RuntimeError, match="needs Pillow"):
        td.rescale_view(img, depth, K, (24, 16))


def test_color_jitter_and_hsv_match():
    from matplotlib.colors import hsv_to_rgb, rgb_to_hsv

    rng = np.random.default_rng(3)
    img = rng.random((9, 13, 3)).astype(np.float32)
    img[0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 1]]
    for x in (img, img.astype(np.float64)):
        hsv = td.rgb_to_hsv(x)
        np.testing.assert_array_equal(hsv, rgb_to_hsv(x))
        np.testing.assert_array_equal(td.hsv_to_rgb(hsv), hsv_to_rgb(hsv))
    for seed in range(8):
        got = td.color_jitter(img, np.random.default_rng(seed))
        want = jd.color_jitter(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_correspondences_match_jax():
    views = jd.synthetic_views(2, 24, 32, 24.0, seed=4)

    def view(v):
        img, depth, K, c2w = v["img"], v["depth"], v["K"], v["c2w"]
        return jd.finalize_view(img, depth, K, c2w)

    v1, v2 = view(views[0]), view(views[1])
    tv1 = td.finalize_view(views[0]["img"], views[0]["depth"],
                           views[0]["K"], views[0]["c2w"])
    for k in v1:
        np.testing.assert_array_equal(tv1[k], v1[k])
    assert_views_equal(td.extract_correspondences_from_pts3d(v1, v2),
                       jd.extract_correspondences_from_pts3d(v1, v2))
    for n, nneg in ((64, 0.0), (200, 0.3), (800, 0.5)):
        got = td.extract_correspondences_from_pts3d(
            v1, v2, n, rng=np.random.default_rng(n), nneg=nneg)
        want = jd.extract_correspondences_from_pts3d(
            v1, v2, n, rng=np.random.default_rng(n), nneg=nneg)
        assert_views_equal(got, want)


@pytest.fixture(scope="module")
def posed_root(tmp_path_factory):
    """Two scenes written by the port's writer (PNG + .npy)."""
    root = tmp_path_factory.mktemp("posed")
    td.write_synthetic_scene(root, name="s0", n_views=5, h=32, w=48)
    td.write_synthetic_scene(root, name="s1", n_views=4, h=40, w=30, seed=1)
    return root


POSED_KW = [
    dict(resolution=(48, 32)),
    dict(resolution=[(48, 32), (32, 32)], aug_crop=4, n_corres=20,
         nneg=0.25, transform="color_jitter"),
]


@pytest.mark.parametrize("kw", POSED_KW, ids=["plain", "augmented"])
@pytest.mark.parametrize("mode", ["sequential", "workers", "shard"])
def test_posed_dataset_batches_match_jax(posed_root, kw, mode):
    bkw = dict(batch_size=2, seed=3, n_epochs=2)
    if mode == "workers":
        bkw["num_workers"] = 4
    elif mode == "shard":
        bkw["shard"] = (1, 3)
    ds_t = td.PosedMultiViewDataset(posed_root, scenes=["s0"], **kw)
    ds_j = jd.PosedMultiViewDataset(posed_root, scenes=["s0"], **kw)
    assert len(ds_t) == len(ds_j) == 18
    got = list(ds_t.batches(**bkw))
    want = list(ds_j.batches(**bkw))
    assert got and got[0]["img1"].dtype == torch.float32
    assert_batches_equal(got, want, f"{mode} {kw}")


def test_portrait_scene_and_arithmetic(posed_root):
    kw = dict(resolution=(32, 24), n_corres=12)
    t0 = td.PosedMultiViewDataset(posed_root, scenes=["s1"], **kw)
    j0 = jd.PosedMultiViewDataset(posed_root, scenes=["s1"], **kw)
    # portrait views are stored transposed; correspondences swap back
    assert_batches_equal(list(t0.batches(2, seed=0)),
                         list(j0.batches(2, seed=0)), "portrait")
    t_all = td.PosedMultiViewDataset(posed_root, **kw)
    j_all = jd.PosedMultiViewDataset(posed_root, **kw)
    for tds, jds in ((t0 + t_all, j0 + j_all), (3 * t0, 3 * j0),
                     (7 @ t_all, 7 @ j_all), (2 * (5 @ t0) + t_all,
                                              2 * (5 @ j0) + j_all)):
        assert len(tds) == len(jds) and repr(tds) == repr(jds)
        assert_batches_equal(list(tds.batches(2, seed=1, n_epochs=2)),
                             list(jds.batches(2, seed=1, n_epochs=2)),
                             repr(tds))
    with pytest.raises(ValueError, match="disagree"):
        td.PosedMultiViewDataset(posed_root, resolution=(48, 32)) + t0


def test_prefetch_iter_order_errors_and_abandon():
    items = [{"i": i} for i in range(7)]
    assert list(td.prefetch_iter(iter(items), depth=2)) == items

    def boom():
        yield {"x": 1}
        raise ValueError("producer failed")

    it = td.prefetch_iter(boom())
    assert next(it) == {"x": 1}
    with pytest.raises(ValueError, match="producer failed"):
        next(it)

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield {"i": i}
                i += 1
        finally:
            closed.set()

    before = threading.active_count()
    it = td.prefetch_iter(endless(), depth=2)
    assert [next(it)["i"] for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed.wait(timeout=5.0), "wrapped generator was not closed"
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before


# -- the nine loaders ---------------------------------------------------------

LOADERS = {
    "Co3d": ("write_synthetic_co3d", dict(n_views=8),
             lambda L, r, **kw: L.Co3d(ROOT=r, split="train", **kw)),
    "Co3d_rand_bg": ("write_synthetic_co3d", dict(n_views=8),
                     lambda L, r, **kw: L.Co3d(ROOT=r, mask_bg="rand",
                                               **kw)),
    "WildRGBD": ("write_synthetic_wildrgbd", dict(n_views=8),
                 lambda L, r, **kw: L.WildRGBD(ROOT=r, **kw)),
    "ScanNetpp": ("write_synthetic_scannetpp", dict(n_views=6),
                  lambda L, r, **kw: L.ScanNetpp(ROOT=r, **kw)),
    "ARKitScenes": ("write_synthetic_arkitscenes", dict(n_views=6),
                    lambda L, r, **kw: L.ARKitScenes(ROOT=r, **kw)),
    "BlendedMVS": ("write_synthetic_blendedmvs", dict(n_views=6),
                   lambda L, r, **kw: L.BlendedMVS(ROOT=r, split="train",
                                                   **kw)),
    "MegaDepth": ("write_synthetic_megadepth", dict(n_views=6),
                  lambda L, r, **kw: L.MegaDepth(ROOT=r, split="train",
                                                 **kw)),
    "Waymo": ("write_synthetic_waymo", dict(n_views=6),
              lambda L, r, **kw: L.Waymo(ROOT=r, **kw)),
    "StaticThings3D": ("write_synthetic_staticthings3d", dict(n_views=4),
                       lambda L, r, **kw: L.StaticThings3D(ROOT=r, **kw)),
    "Habitat": ("write_synthetic_habitat", dict(n_scenes=3),
                lambda L, r, **kw: L.Habitat(1000, ROOT=r, **kw)),
}
LOADER_KW = dict(resolution=(32, 24), n_corres=10,
                 transform="color_jitter")


def loader_batches(L, name, root):
    ds = LOADERS[name][2](L, root, **LOADER_KW)
    return len(ds), take(ds.batches(2, seed=0, n_epochs=2), 3)


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_on_jax_fixture_matches_jax(name, tmp_path):
    writer, wkw, _ = LOADERS[name]
    getattr(jl, writer)(tmp_path, **wkw)
    n_t, got = loader_batches(tl, name, tmp_path)
    n_j, want = loader_batches(jl, name, tmp_path)
    assert n_t == n_j and len(got) >= 1
    assert_batches_equal(got, want, name)


@pytest.mark.parametrize("name", sorted(set(LOADERS) - {"Co3d_rand_bg"}))
def test_port_writer_read_by_jax_loader(name, tmp_path):
    """The port's writers produce files JAX's loaders read the same (and
    the port's loaders read as JAX's do)."""
    writer, wkw, _ = LOADERS[name]
    getattr(tl, writer)(tmp_path / "port", **wkw)
    getattr(jl, writer)(tmp_path / "jax", **wkw)
    _, from_port = loader_batches(jl, name, tmp_path / "port")
    _, from_jax = loader_batches(jl, name, tmp_path / "jax")
    assert_batches_equal(from_port, from_jax, name)
    _, port_on_port = loader_batches(tl, name, tmp_path / "port")
    assert_batches_equal(port_on_port, from_jax, name)


def test_make_dataset_spec(tmp_path):
    jl.write_synthetic_scannetpp(tmp_path / "a", n_views=6)
    jl.write_synthetic_waymo(tmp_path / "b", n_views=6)
    spec = (f"ScanNetpp(ROOT='{tmp_path / 'a'}', resolution=(32, 24)) + "
            f"4 @ Waymo(ROOT='{tmp_path / 'b'}', resolution=(32, 24))")
    t, j = tl.make_dataset(spec), jl.make_dataset(spec)
    assert len(t) == len(j) == 9 and repr(t) == repr(j)
    assert_batches_equal(take(t.batches(3, seed=2), 2),
                         take(j.batches(3, seed=2), 2), "spec")
    with pytest.raises(NameError):
        tl.make_dataset("__import__('os')")


def test_png16_against_pillow(tmp_path):
    rng = np.random.default_rng(9)
    for shape in ((24, 33), (1, 5), (17, 1)):
        a = rng.integers(0, 65536, shape).astype(np.uint16)
        PIL.Image.fromarray(a).save(tmp_path / "pil.png")
        np.testing.assert_array_equal(png.read_png16(tmp_path / "pil.png"),
                                      a)
        png.write_png16(tmp_path / "port.png", a)
        back = np.asarray(PIL.Image.open(tmp_path / "port.png"))
        assert back.dtype == np.uint16
        np.testing.assert_array_equal(back, a)
    # a smooth map makes Pillow's adaptive row filters pick Sub/Up/Paeth
    g = (np.add.outer(np.arange(40), np.arange(50)) * 700).astype(np.uint16)
    PIL.Image.fromarray(g).save(tmp_path / "smooth.png")
    np.testing.assert_array_equal(png.read_png16(tmp_path / "smooth.png"), g)
    # each reader refuses the other's files
    with pytest.raises(ValueError, match="16-bit grey"):
        png.read_png(tmp_path / "smooth.png")
    PIL.Image.fromarray(np.zeros((3, 4, 3), np.uint8)).save(
        tmp_path / "rgb8.png")
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png16(tmp_path / "rgb8.png")
    with pytest.raises(ValueError):
        png.write_png16(tmp_path / "x.png", g.astype(np.int32))


# -- the CLI -----------------------------------------------------------------


def _capture_history(monkeypatch, module):
    seen = {}
    inner = module.train_loop

    def spy(*a, **kw):
        out = inner(*a, **kw)
        seen["history"] = out[1]
        return out

    monkeypatch.setattr(module, "train_loop", spy)
    return seen


def test_cli_pretrain_tiny_matches_jax(tmp_path, monkeypatch, capsys):
    """Four plain float32 steps (accum 1) of the MASt3R fine-tuning loss,
    with colour jitter and correspondences, through both CLIs."""
    from instantsplat_tpu.cli import pretrain as jcli
    from instantsplat_tpu.train_dust3r import trainer as jt
    from instantsplat_tpu_torch import convert
    from instantsplat_tpu_torch.cli import pretrain as tcli
    from instantsplat_tpu_torch.train_dust3r import trainer as tt

    td.write_synthetic_scene(tmp_path / "data", n_views=5, h=32, w=48)
    spec = (f"PosedMultiViewDataset('{tmp_path / 'data'}', "
            "resolution=(48, 32), n_corres=16, transform='color_jitter')")
    argv = ["--train_dataset", spec, "--tiny", "--criterion",
            "mast3r_finetune", "--steps", "4", "--batch_size", "1",
            "--num_workers", "2", "--print_freq", "1", "--lr", "5e-4",
            "--warmup_steps", "1"]
    seen_t = _capture_history(monkeypatch, tt)
    model = tcli.main(argv + ["--device", "cpu", "--output_dir",
                              str(tmp_path / "t")])
    out_t = capsys.readouterr().out
    seen_j = _capture_history(monkeypatch, jt)
    params = jcli.main(argv + ["--output_dir", str(tmp_path / "j")])
    out_j = capsys.readouterr().out

    ht, hj = seen_t["history"], seen_j["history"]
    assert [s for s, _ in ht] == [s for s, _ in hj] == [1, 2, 3, 4]
    for (_, mt), (_, mj) in zip(ht, hj):
        assert mt.keys() == mj.keys()
        for k in mj:
            assert abs(mt[k] - mj[k]) <= 1e-4 * max(abs(mj[k]), 1e-6), k
    # the dataset and done lines (JAX also reports how many of the test
    # process's eight virtual devices the batch uses; one device has none)
    def lines(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("[pretrain] dataset", "[pretrain] done"))]

    assert len(lines(out_t)) == 2 and lines(out_t) == lines(out_j)
    tree = convert.mast3r_to_numpy(model.state_dict())
    for (path, a), b in zip(_leaves(tree), jax_leaves(params)):
        scale = max(float(np.linalg.norm(b)), 1e-6)
        assert float(np.linalg.norm(a - b)) / scale <= 1e-4, path
    # each package resumes the other's checkpoint-last.npz: none is taken
    # again for the finished run, so both stop at once
    assert (tmp_path / "t" / "checkpoint-last.npz").is_file()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def jax_leaves(params):
    return [np.asarray(a) for _, a in _leaves(params)]


def test_cli_defaults_to_the_card(monkeypatch, tmp_path):
    from instantsplat_tpu_torch.cli import pretrain as tcli

    td.write_synthetic_scene(tmp_path, n_views=3, h=32, w=48)
    argv = ["--train_dataset",
            f"PosedMultiViewDataset('{tmp_path}')", "--tiny"]
    assert tcli.build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(argv)
    # a two-rank launch on a machine without cards: rank 0 has no cuda:0
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="needs cuda:0"):
        tcli.main(argv)
