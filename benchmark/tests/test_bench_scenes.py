"""The scene generator repeats by seed, gives every seed the same sizes,
keeps the points that the co-visibility rule keeps, and writes files the
program reads back as written."""

import numpy as np

from benchmark.scenes import relief


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


GEO = relief.geometry(3, 24, 40, 0.15, 0.01)


def test_same_seed_same_bytes_other_seed_same_sizes(tmp_path):
    a = relief.make_scene(tmp_path / "a", 2**33 + 7, GEO)
    b = relief.make_scene(tmp_path / "b", 2**33 + 7, GEO)
    c = relief.make_scene(tmp_path / "c", 99, GEO)
    assert _files(a.root) == _files(b.root)
    fa, fc = _files(a.root), _files(c.root)
    assert fa.keys() == fc.keys() and fa != fc
    assert a.xyz.shape == c.xyz.shape and a.images.shape == c.images.shape


def test_the_program_reads_the_scene_as_written(tmp_path):
    from instantsplat_tpu_torch.data import scene as scene_io

    s = relief.make_scene(tmp_path / "s", 5, GEO)
    info = scene_io.read_scene(s.root, 3, device="cpu")
    assert np.array_equal(info.points, s.xyz)
    assert np.array_equal(np.round(info.colors * 255).astype(np.uint8),
                          s.rgb8)
    for k, cam in enumerate(info.cameras):
        assert np.array_equal(np.round(cam.image.numpy() * 255).astype(
            np.uint8), s.images[k])
        assert float(cam.fx) == np.float32(s.fx)
    conf = np.load(s.root / "sparse_3/0/confidence_dsp.npy")
    assert np.array_equal(conf, s.confidence)


def _co_visible_by_pixel(depth, points, fx, w2cs, thr):
    """The rule walked pixel by pixel: a pixel of view i is co-visible where
    a pixel of a view before it projects onto it with normalised depths
    within thr."""
    v, h, w = depth.shape
    out = np.zeros((v, h, w), bool)
    for i in range(1, v):
        src = depth[:i].reshape(-1)
        src = (src - src.min()) / (src.max() - src.min())
        own = (depth[i] - depth[i].min()) / (depth[i].max() - depth[i].min())
        for n, p in enumerate(points[:i].reshape(-1, 3)):
            c = w2cs[i][:3, :3] @ p + w2cs[i][:3, 3]
            x = c[0] / c[2] * fx + (w - 1) / 2
            y = c[1] / c[2] * fx + (h - 1) / 2
            if 0 <= x < w and 0 <= y < h and abs(
                    src[n] - own[int(y), int(x)]) < thr:
                out[i, int(y), int(x)] = True
    return out


def test_the_kept_points_follow_the_co_visibility_rule():
    g = relief.geometry(3, 12, 20, 0.15, 0.05)
    depth = np.stack([relief.ray_cast(m, g.fx, 12, 20)[1] for m in g.w2cs])
    drop = _co_visible_by_pixel(np.log(depth), g.points, g.fx, g.w2cs, 0.05)
    assert np.array_equal(g.keep, ~drop)
    assert 0 < drop.sum() and drop[0].sum() == 0
    assert np.array_equal(g.xyz, g.points[g.keep].astype(np.float32))
