"""The frozen counts: the contributing-pair count against a brute-force
walk of every pixel over every splat, and a step's operations against a
hand count."""

import numpy as np
import torch

from benchmark.counts import gs_step
from benchmark.reference import gs_plain
from benchmark.scenes import relief


def _brute_force_pairs(leaves, view, fx, h, w):
    cols, depth, valid, _, _ = gs_plain.project(
        leaves, leaves["cam_poses"][view], fx, fx, h, w)
    idx = torch.nonzero(valid).squeeze(1)
    order = idx[torch.sort(depth[idx], stable=True).indices]
    rows = cols[order].double().numpy()
    total = 0
    for y in range(h):
        for x in range(w):
            log_t = 0.0
            for mx, my, a, b, c, lo, *_ in rows:
                dx, dy = x - mx, y - my
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, np.exp(power + lo))
                if power > 0 or alpha < 1 / 255:
                    continue
                nxt = log_t + np.log1p(-alpha)
                if nxt < np.log(1e-4):
                    break
                log_t = nxt
                total += 1
    return total


def test_contributing_pairs_match_a_brute_force_walk(tmp_path):
    s = relief.make_scene(tmp_path / "s", 3,
                          relief.geometry(3, 20, 36, 0.15, 0.01))
    keep = np.random.default_rng(0).permutation(len(s.xyz))[:300]
    s.xyz, s.rgb8, s.confidence = s.xyz[keep], s.rgb8[keep], \
        s.confidence[keep]
    leaves = gs_plain.initial_state(s, 3, 0.1, "cpu")
    for view in range(3):
        assert gs_step.contributing_pairs(leaves, view, s.fx, 20, 36) == \
            _brute_force_pairs(leaves, view, s.fx, 20, 36)


def test_step_flops_by_hand():
    # 10 Gaussians (59 parameters each), 7 pose parameters, 100 pairs, a
    # 4 x 5 image: front end 10 * 555, pairs 100 * 85, rectangles 10 * 35,
    # loss 4 * 5 * 3 * 411, Adam 597 * 12
    assert gs_step.step_flops(100, 10, 597, 4, 5) == (
        5550 + 8500 + 350 + 24660 + 7164)


def test_compositor_work_by_hand():
    ops, nbytes = gs_step.compositor_work(100, 10, 4, 5)
    assert ops == 100 * 85 + 10 * 35
    assert nbytes == 3 * 10 * 40 + 20 * 32
