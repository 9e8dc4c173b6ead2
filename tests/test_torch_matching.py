"""The port's reciprocal nearest-neighbour matching (ops/matching.py)
against the JAX package's, on the CPU: the same seeded descriptors give
the same indices and the same match sets, with no host read between
the rounds. The descriptors are
well separated (unit-normalised 24-d Gaussians, and tests/test_aligner.py's
world-position field), so the two packages' float32 distances, summed in
different orders, cannot swap two candidates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.init.aligner import PairPrediction as JaxPairs
from instantsplat_tpu.ops import matching as jm
from instantsplat_tpu_torch.ops import matching as m
from torch_init_cases import attach_world_desc, sparse_scene

torch.set_num_threads(2)


def _unit(rng, shape):
    d = rng.standard_normal(shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pair(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    d1 = _unit(rng, (h, w, 24))
    if kind == "independent":
        return d1, _unit(rng, (h, w, 24))
    # a shifted copy with noise: most seeds have a true partner
    d2 = np.roll(d1, (-2, -3), axis=(0, 1)) + 0.05 * _unit(rng, (h, w, 24))
    return d1, (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(
        np.float32)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_nn_indices_matches_jax(chunk):
    rng = np.random.default_rng(0)
    db = _unit(rng, (31 * 40, 24))
    q = _unit(rng, (300, 24))
    got = m.nn_indices(q, db, chunk=chunk, device="cpu").numpy()
    ref = np.asarray(jm.nn_indices(jnp.asarray(q), jnp.asarray(db),
                                   chunk=chunk))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["independent", "shifted"])
@pytest.mark.parametrize("hw,subsample", [((24, 32), 4), ((31, 40), 8),
                                          ((31, 40), 4)])
def test_fast_reciprocal_nns_matches_jax(kind, hw, subsample):
    d1, d2 = _pair(kind, *hw, seed=hw[0] + subsample)
    chunk = 32  # smaller than the seed count
    got = m.fast_reciprocal_nns(d1, d2, subsample=subsample, chunk=chunk,
                                device="cpu")
    ref = jm.fast_reciprocal_nns(d1, d2, subsample=subsample, chunk=chunk)
    assert len(ref[0]) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_world_position_field_matches_jax():
    c2w, _, preds = sparse_scene(JaxPairs, n_views=3)
    attach_world_desc(preds, c2w)
    n = 0
    for e in range(len(preds.edges)):
        got = m.fast_reciprocal_nns(preds.desc_i[e], preds.desc_j[e],
                                    subsample=4, chunk=64, device="cpu")
        ref = jm.fast_reciprocal_nns(preds.desc_i[e], preds.desc_j[e],
                                     subsample=4, chunk=64)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        n += len(ref[0])
    assert n > 100


@pytest.mark.parametrize("kind", ["independent", "shifted"])
def test_rounds_read_nothing_and_match_jax(monkeypatch, kind):
    """The rounds run JAX's fixed trip with no host read between them
    (tests/torch_host_reads.py's guard around the whole loop), on
    descriptors whose last seed converges before max_iter (the first k
    with no seed active after k rounds), and the matches are JAX's."""
    from torch_host_reads import no_host_reads

    real, rounds = m._reciprocal_iterate, []

    def guarded(d1, d2, xy1, max_iter, chunk):
        with no_host_reads("reciprocal rounds"):
            out = real(d1, d2, xy1, max_iter, chunk)
        rounds.append(next((k for k in range(1, max_iter + 1)
                            if not real(d1, d2, xy1, k, chunk)[2].any()),
                           max_iter))
        return out

    monkeypatch.setattr(m, "_reciprocal_iterate", guarded)
    d1, d2 = _pair(kind, 31, 40, seed=7)
    got = m.fast_reciprocal_nns(d1, d2, subsample=4, max_iter=10, chunk=32,
                                device="cpu")
    ref = jm.fast_reciprocal_nns(d1, d2, subsample=4, max_iter=10, chunk=32)
    assert len(rounds) == 1 and 1 < rounds[0] < 10, rounds
    assert len(ref[0]) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_identity_and_shift():
    """tests/test_components.py's two cases through the port alone."""
    rng = np.random.default_rng(2)
    desc = _unit(rng, (24, 32, 8))
    p1, p2 = m.fast_reciprocal_nns(desc, desc, subsample=8, chunk=256,
                                   device="cpu")
    assert len(p1) > 0
    np.testing.assert_array_equal(p1, p2)
    rng = np.random.default_rng(3)
    desc = rng.standard_normal((16, 40, 8)).astype(np.float32)
    desc2 = np.roll(desc, -5, axis=1)
    p1, p2 = m.fast_reciprocal_nns(desc, desc2, subsample=4, chunk=256,
                                   device="cpu")
    inner = (p1[:, 0] >= 5) & (p1[:, 0] < 35)
    assert inner.sum() > 10
    np.testing.assert_array_equal(p2[inner, 0], p1[inner, 0] - 5)
    np.testing.assert_array_equal(p2[inner, 1], p1[inner, 1])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        m.fast_reciprocal_nns(np.zeros((4, 4, 2), np.float32),
                              np.zeros((4, 4, 2), np.float32))
