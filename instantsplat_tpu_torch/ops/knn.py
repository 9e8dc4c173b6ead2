"""Mean squared distance to the k nearest neighbours, for the initial
Gaussian scales (port of instantsplat_tpu/ops/knn.py).

Chunked `torch.cdist` picks k+4 candidates per query; their distances are
then recomputed exactly from coordinate differences, so the result does
not depend on the Gram-form rounding that cdist may use.
"""

from __future__ import annotations

import torch


def mean_knn_dist2(points: torch.Tensor, k: int = 3,
                   chunk: int = 1024) -> torch.Tensor:
    """[N, 3] float32 -> [N] mean of the k smallest squared distances to
    other points, clamped to >= 1e-7 (reference `clamp_min(distCUDA2, 1e-7)`).
    """
    n = points.shape[0]
    # centering keeps the Gram expansion's cancellation error at the scale
    # of the cloud radius, not of its distance from the origin
    pts = points - points.mean(dim=0, keepdim=True)
    k_cand = min(k + 4, n - 1)
    out = []
    for s in range(0, n, chunk):
        q = pts[s:s + chunk]
        d2 = torch.cdist(q, pts).square_()
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + s] = float("inf")  # exclude self
        cand = torch.topk(d2, k_cand, dim=1, largest=False).indices
        diff = q[:, None, :] - pts[cand]
        exact = torch.sum(diff * diff, dim=-1)
        exact = torch.where(cand == (rows + s)[:, None],
                            torch.full_like(exact, float("inf")), exact)
        out.append(torch.topk(exact, k, dim=1, largest=False).values)
    knn = torch.cat(out, dim=0)
    return torch.clamp(knn.mean(dim=-1), min=1e-7)
