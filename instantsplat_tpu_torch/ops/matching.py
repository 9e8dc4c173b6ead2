"""Reciprocal nearest-neighbour descriptor matching (port of
instantsplat_tpu/ops/matching.py, the MASt3R matching core).

Starting from a subsampled pixel grid of image 1, alternate "nearest
neighbour in image 2 of the current image-1 points" and "nearest neighbour
in image 1 of those image-2 points" until each seed reaches a fixed point
(at most `max_iter` rounds); converged pairs are reciprocal matches.

Each nearest-neighbour query is an argmin over |q|^2 + |p|^2 - 2 q.p in
float32, in chunks of `chunk` queries, as the JAX package computes it. The
product is one large matmul; the package switches TF32 off on import, and
it must stay off here: TF32's 10-bit mantissa would flip nearest
neighbours. `torch.argmin` returns the first index at a tie, as
`jnp.argmin` does. The rounds are JAX's fixed-trip loop: exactly
`max_iter` of them, each querying every seed (a converged seed keeps its
indices through the mask), with no read of the device between them; the
host reads the result once, after the last round.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsplat_tpu_torch import resolve_device


def _nn(queries: torch.Tensor, database: torch.Tensor, d2: torch.Tensor,
        chunk: int) -> torch.Tensor:
    q2 = torch.sum(queries * queries, -1)
    out = []
    for s in range(0, queries.shape[0], chunk):
        qb = queries[s:s + chunk]
        dist = q2[s:s + chunk, None] + d2[None, :] - 2.0 * (qb @ database.T)
        out.append(torch.argmin(dist, dim=1))
    return torch.cat(out)


def nn_indices(queries, database, chunk: int = 4096,
               device="cuda") -> torch.Tensor:
    """[Q, D] x [N, D] -> [Q] index of the nearest database row (L2)."""
    dev = resolve_device(device)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    database = torch.as_tensor(database, dtype=torch.float32, device=dev)
    return _nn(queries, database, torch.sum(database * database, -1), chunk)


@torch.no_grad()
def _reciprocal_iterate(d1: torch.Tensor, d2: torch.Tensor,
                        xy1: torch.Tensor, max_iter: int, chunk: int):
    """The ping-pong on flat descriptor tables d1 [N1, D], d2 [N2, D] from
    seed indices xy1 [M]: max_iter masked rounds, nothing read on the host.
    -> (xy1, xy2, active), active = not converged."""
    sq1 = torch.sum(d1 * d1, -1)
    sq2 = torch.sum(d2 * d2, -1)
    xy2 = torch.full_like(xy1, -1)
    active = torch.ones(xy1.shape, dtype=torch.bool, device=xy1.device)
    for _ in range(max_iter):
        new_xy2 = torch.where(active, _nn(d1[xy1], d2, sq2, chunk), xy2)
        new_xy1 = torch.where(active, _nn(d2[new_xy2], d1, sq1, chunk), xy1)
        converged = (new_xy1 == xy1) & (new_xy2 == xy2)
        xy1, xy2, active = new_xy1, new_xy2, active & ~converged
    return xy1, xy2, active


def fast_reciprocal_nns(desc1, desc2, subsample=8, max_iter=10,
                        chunk=4096, device="cuda"):
    """desc1 [H1,W1,D], desc2 [H2,W2,D] -> (xy1 [M,2], xy2 [M,2]) matched
    (x, y) int32 pixel coordinates of reciprocal fixed points (numpy)."""
    dev = resolve_device(device)
    h1, w1, d = desc1.shape
    h2, w2, _ = desc2.shape
    d1 = torch.as_tensor(desc1, dtype=torch.float32, device=dev).reshape(-1, d)
    d2 = torch.as_tensor(desc2, dtype=torch.float32, device=dev).reshape(-1, d)

    ys, xs = np.mgrid[subsample // 2:h1:subsample,
                      subsample // 2:w1:subsample].reshape(2, -1)
    xy1_init = torch.as_tensor(np.unique(xs + w1 * ys), device=dev)

    xy1, xy2, active = _reciprocal_iterate(d1, d2, xy1_init, max_iter, chunk)
    keep = ~active.cpu().numpy()  # converged = reciprocal
    xy1 = xy1.cpu().numpy().astype(np.int32)[keep]
    xy2 = xy2.cpu().numpy().astype(np.int32)[keep]
    pts1 = np.stack([xy1 % w1, xy1 // w1], -1)
    pts2 = np.stack([xy2 % w2, xy2 // w2], -1)
    return pts1, pts2
