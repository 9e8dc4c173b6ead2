"""The plain reference's start: its nearest-neighbour scales against a
brute-force search over every pair."""

import pytest
import torch

from benchmark.reference import gs_plain
from benchmark.scenes import relief


def _brute_force(p, k=3):
    p = (p - p.mean(0)).double()
    d = torch.cdist(p, p) ** 2
    d.fill_diagonal_(float("inf"))
    return torch.clamp(torch.topk(d, k, largest=False).values.mean(1),
                       min=1e-7)


@pytest.mark.parametrize("cloud", ["relief", "normal", "slab"])
@pytest.mark.parametrize("chunk", [2048, 7])
def test_knn_matches_a_brute_force_search(cloud, chunk):
    g = torch.Generator().manual_seed(3)
    pts = {"relief": lambda: torch.as_tensor(
               relief.geometry(3, 24, 40, 0.15, 0.01).xyz),
           "normal": lambda: torch.randn(3000, 3, generator=g),
           "slab": lambda: torch.rand(4000, 3, generator=g)
           * torch.tensor([10.0, 1.0, 0.1])}[cloud]()
    got = gs_plain.knn_mean_dist2(pts, chunk=chunk).double()
    want = _brute_force(pts)
    assert float(((got - want).abs() / want).max()) < 1e-5
