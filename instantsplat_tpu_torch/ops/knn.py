"""Mean squared distance to the k nearest neighbours, for the initial
Gaussian scales (port of instantsplat_tpu/ops/knn.py).

On a CUDA tensor one launch of the kernel knn3 (csrc/knn.cu; its header
note says what bounds it and how it is built) computes the 3 nearest by
exact distance, with a running top-3 in registers and no distance matrix.
On a CPU tensor the plain version runs: chunked `torch.cdist` picks k+4
candidates per query; their distances are then recomputed exactly from
coordinate differences, so the result does not depend on the Gram-form
rounding that cdist may use.
"""

from __future__ import annotations

import ctypes

import torch

from instantsplat_tpu_torch.ops.cuda_build import Kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KNN3 = Kernel("knn3", [_P, _P, _I, _P], source="knn.cu")
KERNEL_K = 3  # the neighbours knn3 keeps (the reference's distCUDA2)


def mean_knn_dist2_plain(points: torch.Tensor, k: int = 3,
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


def mean_knn_dist2(points: torch.Tensor, k: int = 3,
                   chunk: int = 1024) -> torch.Tensor:
    """[N, 3] float32 -> [N] mean of the k smallest squared distances to
    other points, clamped to >= 1e-7 (reference `clamp_min(distCUDA2, 1e-7)`).
    A CUDA tensor launches knn3 once on the current stream (k must be 3;
    `chunk` is the plain version's); a CPU tensor takes the plain version.
    """
    if not points.is_cuda:
        return mean_knn_dist2_plain(points, k, chunk)
    if k != KERNEL_K:
        raise ValueError(f"mean_knn_dist2: knn3 keeps {KERNEL_K} neighbours, "
                         f"not {k}")
    if (points.dim() != 2 or points.shape[1] != 3
            or points.dtype != torch.float32 or not points.is_contiguous()):
        raise ValueError("mean_knn_dist2: points must be a contiguous [N, 3] "
                         f"float32 tensor, not {points.dtype} "
                         f"{tuple(points.shape)}")
    n = points.shape[0]
    if n < k + 1:
        raise ValueError(f"mean_knn_dist2: {n} points, at least {k + 1} "
                         "needed")
    # centred as the plain version centres, so the kernel sees its
    # coordinates
    pts = points - points.mean(dim=0, keepdim=True)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        KNN3(pts.data_ptr(), out.data_ptr(), n,
             torch.cuda.current_stream().cuda_stream)
    return out
