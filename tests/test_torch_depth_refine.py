"""The port's TSDF depth refinement and midpoint triangulation
(init/depth_refine.py) against the JAX package's, on the CPU.

`tsdf_refine_depth` is a random search: the test computes JAX's standard
normals with JAX's own `jax.random` calls and hands them to the port's
`_refine`. The same candidate must then win on >= 99.9% of pixels, and
every other pixel must stay within `trunc` of JAX's. "The same
candidate" is judged to 1e-6 relative, not bit for bit: XLA fuses each
candidate's (n - 1) * thresh + d with the normal's own last multiply into
fused multiply-adds, so a candidate JAX picks comes out up to two float32
ulps (4.8e-7 at depth 3) from the port's value of the same candidate.
"""

import jax
import numpy as np
import pytest
import torch

from instantsplat_tpu.init import depth_refine as jdr
from instantsplat_tpu_torch.init import depth_refine as dr

torch.set_num_threads(2)

H, W, F = 24, 32, 40.0


def _plane_case(noise_views=(0,), seed=0):
    """tests/test_aligner.py's TSDF scene: three cameras 0.15 apart facing
    the plane z = 3, seeded noise of 0.05 on the noisy views."""
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    c2w = np.tile(np.eye(4), (3, 1, 1))
    c2w[1, :3, 3] = [0.15, 0, 0]
    c2w[2, :3, 3] = [-0.15, 0, 0]
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    gt = []
    for v in range(3):
        dirs = np.stack([(gx - W / 2) / F, (gy - H / 2) / F,
                         np.ones_like(gx)], -1) @ c2w[v, :3, :3].T
        gt.append((3.0 - c2w[v, 2, 3]) / dirs[..., 2])
    gt = np.stack(gt).astype(np.float32)
    rng = np.random.default_rng(seed)
    noisy = gt.copy()
    for v in noise_views:
        noisy[v] += rng.standard_normal(gt[v].shape).astype(np.float32) * 0.05
    return gt, noisy, np.tile(K, (3, 1, 1)), c2w


def _jax_normals(n_iter, v, nsamples, key=None):
    """The draws of JAX's tsdf_refine_depth, made with its calls."""
    key = jax.random.PRNGKey(0) if key is None else key
    draw = jax.jit(jax.vmap(lambda k: jax.random.normal(k, (H, W, nsamples))))
    out = []
    for _ in range(n_iter):
        key, sub = jax.random.split(key)
        out.append(torch.tensor(np.asarray(draw(jax.random.split(sub, v)))))
    return out


@pytest.mark.parametrize("n_iter,nsamples,chunk,with_conf", [
    (2, 128, 32, False), (1, 64, 64, True), (3, 48, 16, True)])
def test_tsdf_matches_jax_with_its_draws(n_iter, nsamples, chunk, with_conf):
    _, noisy, K, c2w = _plane_case(noise_views=(0, 2))
    confs = None
    if with_conf:
        confs = (1.0 + np.random.default_rng(1).random(noisy.shape)).astype(
            np.float32)
    ref = np.asarray(jdr.tsdf_refine_depth(
        noisy, K, c2w, confs=confs, trunc=0.1, n_iter=n_iter,
        nsamples=nsamples, sample_chunk=chunk))
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    got = dr._refine(t(noisy), t(K), t(c2w),
                     torch.ones(noisy.shape) if confs is None else t(confs),
                     0.1, _jax_normals(n_iter, 3, nsamples), chunk).numpy()
    d = np.abs(got - ref)
    same = d <= 1e-6 * np.abs(ref)
    assert same.mean() >= 0.999, same.mean()
    assert d.max() <= 0.1, d.max()
    assert not np.array_equal(got, noisy)  # the search moved pixels


def test_tsdf_improves_noisy_depth():
    """tests/test_aligner.py::test_tsdf_refine_improves_noisy_depth's gate
    with the port's own generator."""
    gt, noisy, K, c2w = _plane_case()
    for gen in (None, torch.Generator().manual_seed(5)):
        refined = dr.tsdf_refine_depth(noisy, K, c2w, trunc=0.1, n_iter=2,
                                       nsamples=128, device="cpu",
                                       generator=gen).numpy()
        sl = (0, slice(4, -4), slice(4, -4))
        err_before = np.abs(noisy[sl] - gt[sl]).mean()
        err_after = np.abs(refined[sl] - gt[sl]).mean()
        assert err_after < err_before * 0.7, (err_before, err_after)


def test_triangulate_matches_matches_jax():
    rng = np.random.default_rng(0)
    K1 = np.array([[50.0, 0, 16], [0, 52.0, 12], [0, 0, 1]])
    K2 = np.array([[48.0, 0, 15], [0, 47.0, 13], [0, 0, 1]])
    c2w1 = np.eye(4)
    c2w2 = np.eye(4)
    a = 0.2
    c2w2[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]
    c2w2[:3, 3] = [0.5, 0.1, 0]
    xy1 = rng.uniform(0, 32, (50, 2))
    xy2 = rng.uniform(0, 24, (50, 2))
    got = dr.triangulate_matches(xy1, xy2, K1, K2, c2w1, c2w2)
    ref = jdr.triangulate_matches(xy1, xy2, K1, K2, c2w1, c2w2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    # exact correspondences triangulate onto their points
    pts = np.array([[0.2, 0.1, 3.0], [-0.3, 0.2, 4.0], [0.0, 0.0, 2.5]])

    def project(p, K, c2w):
        pc = (p - c2w[:3, 3]) @ c2w[:3, :3]
        return pc[:2] / pc[2] * K[[0, 1], [0, 1]] + K[:2, 2]

    tri, gap = dr.triangulate_matches(
        np.stack([project(p, K1, c2w1) for p in pts]),
        np.stack([project(p, K2, c2w2) for p in pts]), K1, K2, c2w1, c2w2)
    np.testing.assert_allclose(tri, pts, atol=1e-9)
    assert gap.max() < 1e-9
