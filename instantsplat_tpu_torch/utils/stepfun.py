"""Step-function (piecewise-constant PDF) resampling — mip-NeRF utilities
(a copy of instantsplat_tpu/utils/stepfun.py; numpy only).

Clean-room numpy port of the subset of utils/stepfun.py the reference uses:
`sample_np` (inverse-CDF sampling from a step function over sorted bin
endpoints, utils/stepfun.py:221-251) powers the constant-speed
re-parameterization of the ellipse render path
(utils/pose_utils.py:344-346), plus the small helpers (`searchsorted`,
`weighted_percentile`, `query`) for completeness.
"""

from __future__ import annotations

import numpy as np


def searchsorted(a, v):
    """For each v: indices (idx_lo, idx_hi) of the bracketing entries of
    sorted array a (utils/stepfun.py:6-25 semantics, vectorized last dim)."""
    i = np.searchsorted(a, v, side="right")
    idx_hi = np.clip(i, 0, len(a) - 1)
    idx_lo = np.clip(i - 1, 0, len(a) - 1)
    return idx_lo, idx_hi


def integrate_weights(w):
    """Exclusive cumulative sum padded to [0, ..., 1] (CDF over bins)."""
    cw = np.cumsum(w, axis=-1)
    cw = cw / np.maximum(cw[..., -1:], np.finfo(np.float32).eps)
    shape = cw.shape[:-1] + (1,)
    return np.concatenate(
        [np.zeros(shape), cw[..., :-1], np.ones(shape)], axis=-1)


def invert_cdf(u, t, w_logits):
    """Invert the CDF of the step function defined by (t, softmax(w))."""
    w = np.exp(w_logits - w_logits.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    cw = integrate_weights(w)
    idx_lo, idx_hi = searchsorted(cw, u)
    t_lo, t_hi = t[idx_lo], t[idx_hi]
    cw_lo, cw_hi = cw[idx_lo], cw[idx_hi]
    denom = np.where(cw_hi - cw_lo <= 0, 1.0, cw_hi - cw_lo)
    frac = np.clip((u - cw_lo) / denom, 0.0, 1.0)
    return t_lo + frac * (t_hi - t_lo)


def sample_np(rand, t, w_logits, num_samples, single_jitter=False,
              deterministic_center=False):
    """Piecewise-constant PDF sampling (utils/stepfun.py:221-251).

    t: [num_bins + 1] sorted bin endpoints; w_logits: [num_bins] bin weight
    logits; rand: None for deterministic linspace sampling or a
    numpy Generator for jittered sampling.
    """
    eps = np.finfo(np.float32).eps
    if rand is None or rand is False:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = np.linspace(pad, 1.0 - pad - eps, num_samples)
        else:
            u = np.linspace(0, 1.0 - eps, num_samples)
    else:
        u_max = eps + (1 - eps) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - eps
        d = 1 if single_jitter else num_samples
        u = (np.linspace(0, 1 - u_max, num_samples)
             + rand.random(d) * max_jitter)
    return invert_cdf(u, np.asarray(t, np.float64),
                      np.asarray(w_logits, np.float64))


def weighted_percentile(t, w, ps):
    """Percentiles of a step function (t [n+1], w [n])."""
    cw = integrate_weights(np.asarray(w, np.float64))
    return np.interp(np.asarray(ps) / 100.0, cw, t)


def query(tq, t, y, outside_value=0):
    """Look up step-function values y (over bins t) at query points tq."""
    idx_lo, _ = searchsorted(t, tq)
    idx = np.clip(idx_lo, 0, len(y) - 1)
    out = np.asarray(y)[idx]
    outside = (tq < t[0]) | (tq >= t[-1])
    return np.where(outside, outside_value, out)
